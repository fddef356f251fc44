"""External validation against the compiled *reference binary*.

These tests build /root/reference's own CLDPC/CModulate sources in place
(scripts/refcheck/build.sh, MKL type-stubbed) and diff faid against
them on identical inputs — the independent oracle that converts the
numpy/C++/XLA lockstep chain from self-consistent to externally
proven (VERDICT round 1, item 1).

Skipped automatically when the harness cannot be built (needs g++ and an
AVX-512VL/BW host).  The full six-method decode sweep lives in
scripts/refcheck/run_parity.py (recorded in docs/refcheck_parity.json);
here we keep one fast decode case per skeleton plus the full modem and
quantizer surface.
"""

from __future__ import annotations

import pathlib
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest

from faid.config import DecodeMethod, DecoderConfig
from faid.decoders.core import build_decoder
from faid.ops import fixed_point, modem

REPO = pathlib.Path(__file__).resolve().parents[1]
HARNESS = REPO / ".refbuild" / "refharness"
N_VAR, N_INFO = 17664, 14592

import sys
sys.path.insert(0, str(REPO / "scripts" / "refcheck"))
from common import write_profile  # noqa: E402  (shared Profile template)


@pytest.fixture(scope="module")
def harness():
    if not HARNESS.exists():
        r = subprocess.run(
            ["bash", str(REPO / "scripts/refcheck/build.sh")],
            capture_output=True, text=True)
        if r.returncode != 0 or not HARNESS.exists():
            pytest.skip(f"reference harness build failed: {r.stderr[-500:]}")
    # AVX-512VL/BW code compiles on any x86 toolchain but SIGILLs on CPUs
    # without it - probe at runtime (argless run prints usage, exit != 0
    # is fine; death by signal is a negative returncode).
    probe = subprocess.run([str(HARNESS)], capture_output=True)
    if probe.returncode < 0:
        pytest.skip(f"reference harness not runnable on this CPU "
                    f"(signal {-probe.returncode})")
    return HARNESS


@pytest.fixture()
def workdir(tmp_path):
    write_profile(tmp_path, 2, 1, 6)
    return tmp_path


def _ref(harness, workdir, mode, *args):
    subprocess.run([str(harness), mode, *map(str, args)],
                   cwd=workdir, check=True)


def test_quantizer_parity(harness, workdir):
    """float2LimitChar_{1..6}bit (reference CLDPC.cpp:4385-4770) ==
    ops.fixed_point.quantize_llr on adversarial floats (half-integer
    boundaries, saturation, signed zero)."""
    rng = np.random.default_rng(3)
    x = np.concatenate([
        rng.standard_normal(20000).astype(np.float32) * 1.5,
        (np.arange(-200, 201) / 2.0 / 13.0).astype(np.float32),
        (np.arange(-200, 201) / 13.0).astype(np.float32),
        np.array([1e6, -1e6, 40.0, -40.0, 9.99, -9.99, 0.0, -0.0],
                 np.float32),
    ]).astype(np.float32)
    (workdir / "x.bin").write_bytes(x.tobytes())
    for bits in (1, 2, 3, 4, 5, 6):
        _ref(harness, workdir, "quant", bits, 13.0, len(x), "x.bin", "q.bin")
        ref = np.frombuffer((workdir / "q.bin").read_bytes(), np.int8)
        got = np.asarray(fixed_point.quantize_llr(x, 13.0, bits))
        np.testing.assert_array_equal(ref, got, err_msg=f"bits={bits}")


@pytest.mark.parametrize("mod_type", [2, 4, 6, 8])
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_modem_parity(harness, workdir, mod_type, depth):
    """CModulate::{BeforeModulationInterleaver, Modulation, Demodulation,
    AfterDeModulationDeInterleaver} (reference CModulate.cpp:95-362) vs
    ops.modem on random codeword bits and noisy symbols.

    Symbols and demapped float LLRs must match bit-for-bit: the demap
    fold reproduces the reference's double-narrowed subtraction
    (CModulate.cpp:291: fabs(x) - 0.6324555) via compensated float32
    arithmetic (ops.modem._fold_sub)."""
    rng = np.random.default_rng(100 * mod_type + depth)
    bits = rng.integers(0, 2, size=(32, N_VAR), dtype=np.int8)
    blob = bits[:, :N_INFO].tobytes() + bits[:, N_INFO:].tobytes()
    (workdir / "bits.bin").write_bytes(blob)
    _ref(harness, workdir, "mod", mod_type, depth, "bits.bin", "sym.bin")
    sym = np.frombuffer((workdir / "sym.bin").read_bytes(),
                        np.float32).reshape(-1, 2)

    il = np.asarray(modem.interleave(bits, depth))
    if mod_type == 2:
        # QPSK is table-mapped like the rest (not the BPSK 2b-1 path).
        mine = np.asarray(modem.modulate_qam(il, mod_type))
    else:
        mine = np.asarray(modem.modulate_qam(il, mod_type))
    np.testing.assert_array_equal(sym.reshape(32, -1, 2), mine)

    noisy = (sym + 0.15 * rng.standard_normal(sym.shape)).astype(np.float32)
    (workdir / "nsym.bin").write_bytes(noisy.tobytes())
    _ref(harness, workdir, "demod", mod_type, depth, "nsym.bin", "llr.bin")
    raw = np.frombuffer((workdir / "llr.bin").read_bytes(), np.float32)
    ref_llr = np.concatenate([raw[:32 * N_INFO].reshape(32, N_INFO),
                              raw[32 * N_INFO:].reshape(32, N_VAR - N_INFO)],
                             axis=1)
    my_llr = np.asarray(modem.deinterleave(
        modem.demodulate_qam(noisy.reshape(32, -1, 2), mod_type), depth))
    np.testing.assert_array_equal(ref_llr, my_llr)


@pytest.mark.parametrize("method,f1,f2", [
    (DecodeMethod.NMS, 26, 32),
    (DecodeMethod.FAID_DTBF, 1, 6),
])
def test_decode_parity(harness, workdir, code, method, f1, f2):
    """One 32-frame word through the reference decoder entry point vs
    faid in stop_mode='group' (the reference's SIMD-word early-stop
    granularity).  Full six-method sweep: scripts/refcheck/run_parity.py."""
    write_profile(workdir, int(method), f1, f2)
    rng = np.random.default_rng(int(method) + 17)
    sigma = 1.0 / np.sqrt(0.8444444 * 2 * 10 ** 0.34)
    y = -1.0 + sigma * rng.standard_normal((32, N_VAR))
    llr = np.clip(np.round(y * 13.0), -7, 7).astype(np.int8)
    blob = llr[:, :N_INFO].tobytes() + llr[:, N_INFO:].tobytes()
    (workdir / "llr.bin").write_bytes(blob)
    _ref(harness, workdir, "decode", int(method), 6, 1, "llr.bin",
         "hard.bin")
    ref = np.frombuffer((workdir / "hard.bin").read_bytes(),
                        np.int8).reshape(32, N_VAR)

    dcfg = DecoderConfig.for_method(method, max_iter=6, factor_1=f1,
                                    factor_2=f2, stop_mode="group")
    decode = build_decoder(code, dcfg)
    got = np.asarray(decode(jnp.asarray(llr))["hard"], dtype=np.int8)
    np.testing.assert_array_equal(ref, got)


def test_itercount_golden(harness, workdir, code):
    """iterCount.txt byte-exactness under group mode: the reference bumps
    one histogram bucket of BF rounds used per 32-frame word
    (CSimulate.cpp:149, 171-179; the decoder return value is an
    up-counter, CDecoder_OMSBF.cpp:2968-3510); our per-frame bf_hist
    divided by 32 must reproduce its ``i: count`` lines byte-for-byte
    on identical LLR inputs (method 3 = OMS+BF, the BF_ITER_COUNT
    path).  This test caught the round-4 writer mis-keying counts as
    cap-minus-used, trusting the reference's wrong doc comment."""
    method, f1, f2 = DecodeMethod.OMS_BF, 1, 2
    write_profile(workdir, int(method), f1, f2)
    rng = np.random.default_rng(91)
    n_words = 4
    # Noisy enough that words use a spread of BF rounds (some clean,
    # some needing several flips, some exhausting the budget).
    sigma = 1.0 / np.sqrt(0.8444444 * 2 * 10 ** 0.375)
    y = -1.0 + sigma * rng.standard_normal((32 * n_words, N_VAR))
    llr = np.clip(np.round(y * 13.0), -7, 7).astype(np.int8)
    blob = b"".join(
        llr[32 * w:32 * (w + 1), :N_INFO].tobytes()
        + llr[32 * w:32 * (w + 1), N_INFO:].tobytes()
        for w in range(n_words))
    (workdir / "llr.bin").write_bytes(blob)
    ref_out = subprocess.run(
        [str(harness), "itercount", str(int(method)), "6", str(n_words),
         "llr.bin"], cwd=workdir, check=True, capture_output=True, text=True)

    dcfg = DecoderConfig.for_method(method, max_iter=6, factor_1=f1,
                                    factor_2=f2, stop_mode="group")
    decode = build_decoder(code, dcfg)
    used = np.asarray(decode(jnp.asarray(llr))["bf_rounds"])
    bf_cap = dcfg.bf.max_iter
    hist = np.bincount(used, minlength=bf_cap + 1)
    assert len(set(used.tolist())) > 1, "degenerate fixture: tune sigma"

    from faid.sim.runner import itercount_ref_lines
    mine = "".join(itercount_ref_lines(hist, bf_cap, word_exact=True))
    assert mine == ref_out.stdout
