"""Typed simulation config absorbing both of the reference's config tiers:
the runtime ``Profile.txt`` (reference CTool.cpp:588-621) and the
compile-time ``#define`` knobs scattered over the decoder files
(OMS_MODE / STOP_EARLY / EF_ELIMINATION / _maxBFiter / _delta / _L0 / _L1 /
_alpha / FAID LUT selection; see reference CDecoder_*.cpp headers).

Everything here is hashable so a config can be a jit-static argument.
"""

from __future__ import annotations

import dataclasses
import enum


class DecodeMethod(enum.IntEnum):
    """Profile.txt DecodeMethod 0-5 (reference README.md:13)."""

    NMS = 0
    OMS = 1
    FAID_DTBF = 2
    OMS_BF = 3
    OMS_DTBF = 4
    FAID_2B1C = 5


class FaidLutFamily(enum.Enum):
    """LUT families selected by #define FAID3/FAID32/FAID2
    (reference CDecoder_FAID.cpp:8)."""

    FAID3 = "faid3"
    FAID32 = "faid32"
    FAID2 = "faid2"
    FAID_2B1C = "faid_2b1c"     # CDecoder_FAID_2B1C.cpp:11-46


@dataclasses.dataclass(frozen=True)
class BFConfig:
    """Bit-flipping post-processor parameters (DTBF / static BF / 2B1C)."""

    kind: str = "none"          # none | static | dtbf | dtbf2b1c
    max_iter: int = 0           # _maxBFiter
    delta: int = 1              # _delta: threshold decrement
    l0: int = 50                # _L0: rounds at the max threshold
    l1: int = 0                 # _L1: rounds at the sub-max threshold
    alpha: int = 1              # _alpha
    gamma: int = 3              # REGULAR_COL_WEIGHT (CTool.h:6)
    static_vote_cap: int = 5    # static BF: flip if vote >= min(max_vote, 5)
    reliability_threshold: int = 13  # 2B1C |LLR| >= 13 marks reliable


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Per-decoder algorithm parameters."""

    method: DecodeMethod = DecodeMethod.FAID_DTBF
    max_iter: int = 6           # MP iterations (Profile MaxIteration)
    factor_1: int = 1           # NMS normalizer / OMS clipping threshold
    factor_2: int = 6
    oms_mode: int = 0           # 0 simple, 1 selective (OMS_MODE)
    oms_offset: int = 1         # simple-OMS offset constant
    stop_early: bool = True     # STOP_EARLY
    ef_elimination: int = 0     # EF_ELIMINATION 0/1/2 (FAID only)
    floor_err_count: int = 100  # selective/EF gate on #unsatisfied checks
    floor_iter_thresh: int = 4  # selective/EF gate on remaining iterations
    lut_family: FaidLutFamily = FaidLutFamily.FAID3
    sign_backtrack: bool = True  # FAID2_SIGN_BACKTRACK
    # Early-stop granularity.  "frame": each frame freezes individually
    # once its syndrome is clean (the group-size-1 limit of the reference
    # rule).  "group": reference semantics — a 32-frame group keeps
    # updating until every frame in it is clean (the reference breaks
    # per 32-frame SIMD word, CDecoder_OMS.cpp:325-327,
    # CDecoder_FAID.cpp:6782-6784).  Use "group" with batch=32 for
    # bit-exact comparison against the reference binary
    # (scripts/refcheck/).
    stop_mode: str = "frame"
    bf: BFConfig = BFConfig()

    @staticmethod
    def for_method(method: DecodeMethod, max_iter: int = 6,
                   factor_1: int = 1, factor_2: int = 6,
                   lut_family: "FaidLutFamily | None" = None,
                   stop_mode: str = "frame") -> "DecoderConfig":
        """Reproduce each reference decoder's compiled-in configuration.

        ``lut_family`` overrides the FAID V2C table selection (the
        reference's #define FAID3/FAID32/FAID2, CDecoder_FAID.cpp:8);
        ignored for non-FAID methods and for 2B1C (which has its own
        table set)."""
        m = DecodeMethod(method)
        base = dict(method=m, max_iter=max_iter,
                    factor_1=factor_1, factor_2=factor_2,
                    stop_mode=stop_mode)
        if m == DecodeMethod.NMS:
            # CLDPC.cpp Decode(): no early stop, plain NMS.
            return DecoderConfig(**base, oms_mode=0, stop_early=False,
                                 bf=BFConfig())
        if m == DecodeMethod.OMS:
            # CDecoder_OMS.cpp: OMS_MODE 1, STOP_EARLY 1.
            return DecoderConfig(**base, oms_mode=1, oms_offset=1,
                                 floor_err_count=100, floor_iter_thresh=4,
                                 bf=BFConfig())
        if m == DecodeMethod.FAID_DTBF:
            # CDecoder_FAID.cpp: OMS_MODE 0, offset 0, EF 0, FAID3,
            # DTBF(_maxBFiter=10, delta=1, L0=50, L1=0, alpha=1).
            return DecoderConfig(**base, oms_mode=0, oms_offset=0,
                                 ef_elimination=0, floor_err_count=0,
                                 floor_iter_thresh=-1,
                                 lut_family=lut_family or FaidLutFamily.FAID3,
                                 bf=BFConfig(kind="dtbf", max_iter=10,
                                             delta=1, l0=50, l1=0, alpha=1))
        if m == DecodeMethod.OMS_BF:
            # CDecoder_OMSBF.cpp: selective OMS + static BF(50).
            return DecoderConfig(**base, oms_mode=1, oms_offset=1,
                                 floor_err_count=100, floor_iter_thresh=4,
                                 bf=BFConfig(kind="static", max_iter=50))
        if m == DecodeMethod.OMS_DTBF:
            # CDecoder_OMS_DTBF.cpp: selective OMS + DTBF(50, L0=0, L1=50).
            return DecoderConfig(**base, oms_mode=1, oms_offset=1,
                                 floor_err_count=100, floor_iter_thresh=4,
                                 bf=BFConfig(kind="dtbf", max_iter=50,
                                             delta=1, l0=0, l1=50, alpha=1))
        if m == DecodeMethod.FAID_2B1C:
            # CDecoder_FAID_2B1C.cpp: EF 1 (floor 50/6), own LUTs,
            # 2B1C DTBF(10, L0=100, L1=0).
            return DecoderConfig(**base, oms_mode=0, oms_offset=0,
                                 ef_elimination=1, floor_err_count=50,
                                 floor_iter_thresh=6,
                                 lut_family=FaidLutFamily.FAID_2B1C,
                                 bf=BFConfig(kind="dtbf2b1c", max_iter=10,
                                             delta=1, l0=100, l1=0, alpha=1))
        raise ValueError(m)


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Full Monte-Carlo simulation config (Profile.txt equivalent)."""

    snr_start: float = 3.0
    snr_pass: float = 0.1
    snr_end: float = 5.0
    decode_method: DecodeMethod = DecodeMethod.FAID_DTBF
    max_iteration: int = 6
    mod_type: int = 2           # 1 BPSK, 2 QPSK, 4 16QAM, 6 64QAM, 8 256QAM
    interleave_depth: int = 1   # InterleaveModType
    factor_1: int = 1
    factor_2: int = 6
    scale: float = 13.0         # quantizer scale
    quant_bits: int = 4         # run path uses the 4-bit quantizer
    file_name: str = "50GPON-CP12"
    z: int = 256
    fake_encode: bool = False   # all-zero codeword path (FAKE_ENCODE)
    # FAID LUT family for DecodeMethod 2 ("faid3" | "faid32" | "faid2",
    # the reference's #define FAID3/FAID32/FAID2).
    faid_lut: str = "faid3"
    seed: int = 0
    # Monte-Carlo stopping rule (reference main.cpp:164, 209-211).
    min_frames: int = 1000
    min_frame_errors: int = 20
    # Sweep economics (no reference equivalent - it burns its full round
    # budget on zero-error deep-floor points): hard per-SNR-point frame
    # budget, and a give-up rule that abandons a point with zero errors
    # after this many frames (the row then records an FER upper bound).
    max_frames_per_snr: int | None = None
    giveup_zero_error_frames: int | None = None
    # Batch geometry: frames decoded per device step, and how many
    # Monte-Carlo rounds run on-device between host syncs (the reference
    # dispatches 50 rounds per pthread, CSimulate.cpp:117).
    batch_per_device: int = 256
    rounds_per_sync: int = 8
    # Channel law: "xla" (float chain) or "fused" (quantile staircase:
    # exact output marginals, different random stream).  See
    # ops/quantile_channel.py.
    channel_backend: str = "xla"
    # Early-stop granularity: "frame" (default) or "group" (reference
    # 32-frame-word emulation; see DecoderConfig.stop_mode).
    stop_mode: str = "frame"
    rate_override: float | None = 0.8444444  # reference CLDPC.cpp:4780

    @property
    def rate(self) -> float:
        if self.rate_override is not None:
            return self.rate_override
        return 14592.0 / 17280.0

    def file_name_key(self) -> str:
        """Map the Profile.txt matrix name to our code-data key."""
        name = self.file_name.lower()
        if "50gpon" in name or "50g" in name:
            return "50gpon"
        return name

    def decoder(self) -> DecoderConfig:
        return DecoderConfig.for_method(
            self.decode_method, self.max_iteration, self.factor_1,
            self.factor_2, lut_family=FaidLutFamily(self.faid_lut),
            stop_mode=self.stop_mode)

    def sigma(self) -> float:
        """Noise sigma from Eb/N0 (reference CSimulate.cpp:70-74; BPSK has
        the extra factor 2 inside the sqrt)."""
        import math

        snr_lin = 10.0 ** (0.1 * self.snr_start)
        if self.mod_type == 1:
            return 1.0 / math.sqrt(2.0 * self.rate * self.mod_type * snr_lin)
        return 1.0 / math.sqrt(self.rate * self.mod_type * snr_lin)

    def sigma_at(self, snr_db: float) -> float:
        import math

        snr_lin = 10.0 ** (0.1 * snr_db)
        if self.mod_type == 1:
            return 1.0 / math.sqrt(2.0 * self.rate * self.mod_type * snr_lin)
        return 1.0 / math.sqrt(self.rate * self.mod_type * snr_lin)
