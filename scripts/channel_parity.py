"""Quantile-channel validation: FER consistency vs the float channel
(companion to docs/refcheck_fer_compare.md).  Same config, same SNR
points, independent random streams; the two FERs and the pre-decoder
BERs must agree within Monte-Carlo error (two-proportion z-test).  Rows
cover QPSK waterfall, BPSK (its own sigma convention), a 4.0 dB
floor-region sigma (with a weakened 2-iteration decoder so frame errors
stay countable - the channel thresholds being validated depend only on
sigma/scale, not on the decoder strength), and 16-QAM depth 2.

    python scripts/channel_parity.py            # -> docs/channel_parity.json
"""

from __future__ import annotations

import json
import math
import sys
import time
import zlib
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

MIN_ERRORS = 60
MAX_ROUNDS = 600
BATCH = 2048
ROUNDS_PER_CALL = 25
Z_THRESHOLD = 4.0
# (label, mod_type, snr_db, max_iteration, interleave_depth)
FER_ROWS = [
    ("qpsk", 2, 3.6, 6, 1),
    ("qpsk", 2, 3.7, 6, 1),
    ("bpsk", 1, 3.6, 6, 1),
    ("qpsk-floor-sigma", 2, 4.0, 2, 1),   # weak decoder: countable FER
    # 16-QAM depth 2: exercises the shared-draw JOINT law (the decoder
    # consumes all of a rail's LLRs) + the interleave wrapper.
    ("16qam-d2", 4, 7.5, 6, 2),   # real-codeword waterfall
]

def stream_id(*parts) -> int:
    """PYTHONHASHSEED-independent stream separator."""
    return zlib.crc32("/".join(str(p) for p in parts).encode()) & 0x7FFFFFFF


def main():
    from faid.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    import jax
    import jax.numpy as jnp

    from faid.code.qc_matrix import load_code
    from faid.config import DecodeMethod, SimConfig
    from faid.sim.pipeline import build_sim_loop

    code = load_code("50gpon")
    points = []
    all_ok = True

    for label, mod, snr, max_it, depth in FER_ROWS:
        res = {}
        for chan in ("xla", "fused"):
            cfg = SimConfig(decode_method=DecodeMethod.FAID_DTBF,
                            max_iteration=max_it, mod_type=mod,
                            interleave_depth=depth,
                            batch_per_device=BATCH, seed=0,
                            channel_backend=chan)
            loop = jax.jit(build_sim_loop(code, cfg, ROUNDS_PER_CALL))
            sigma = jnp.float32(cfg.sigma_at(snr))
            key = jax.random.fold_in(jax.random.key(cfg.seed),
                                     stream_id(chan, label, snr))
            frames = errors = mbits = rounds = 0
            t0 = time.perf_counter()
            while errors < MIN_ERRORS and rounds < MAX_ROUNDS:
                out = jax.device_get(loop(key, sigma, jnp.int32(rounds)))
                rounds += ROUNDS_PER_CALL
                frames += int(out["test_frames"])
                errors += int(out["error_frames"])
                mbits += int(out["mod_error_bits"])
            res[chan] = (frames, errors, mbits)
            print(f"{label:16s} {chan:5s} {snr} dB: {errors}/{frames} "
                  f"FER={errors / max(frames, 1):.3e} modBER-bits={mbits} "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)

        fx, ex, mx = res["xla"]
        ff, ef, mf = res["fused"]
        p = (ex + ef) / (fx + ff) if (ex + ef) else 0.0
        se = math.sqrt(p * (1 - p) * (1 / fx + 1 / ff)) if p > 0 else 0.0
        z = ((ex / fx) - (ef / ff)) / se if se else 0.0
        # modBER z: pre-decoder hard-decision errors, iid per info bit -
        # a high-statistics direct check of the channel law.
        nb_x, nb_f = fx * code.n_info, ff * code.n_info
        pm = (mx + mf) / (nb_x + nb_f)
        sem = math.sqrt(pm * (1 - pm) * (1 / nb_x + 1 / nb_f)) if pm else 0.0
        zm = ((mx / nb_x) - (mf / nb_f)) / sem if sem else 0.0
        ok = abs(z) <= Z_THRESHOLD and abs(zm) <= Z_THRESHOLD
        all_ok &= ok
        points.append({
            "label": label, "mod_type": mod, "snr_db": snr,
            "max_iteration": max_it,
            "xla": {"frames": fx, "errors": ex, "fer": ex / fx,
                    "mod_error_bits": mx},
            "fused": {"frames": ff, "errors": ef, "fer": ef / ff,
                      "mod_error_bits": mf},
            "z_fer": round(z, 3), "z_mod_ber": round(zm, 3),
            "consistent": ok,
        })
        print(f"{label} {snr} dB: z_fer = {z:+.2f}  z_modber = {zm:+.2f} "
              f"({'ok' if ok else 'FAIL'})", flush=True)

    out_path = REPO / "docs" / "channel_parity.json"
    out_path.write_text(json.dumps({
        "config": f"method2 batch={BATCH} real-codeword",
        "z_threshold": Z_THRESHOLD,
        "points": points,
        "all_consistent": all_ok,
    }, indent=1))
    print(f"wrote {out_path}; all_consistent={all_ok}")
    return 0 if all_ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
