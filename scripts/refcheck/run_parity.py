"""Bit-exact external validation of faid against the *reference
binary*.

Feeds identical int8 LLR words into each of the reference's six decode
entry points (CLDPC.h:146-152, compiled via scripts/refcheck/build.sh)
and into faid's xla decoder in stop_mode='group' (the reference's
32-frame-word early-stop granularity), then diffs hard outputs
bit-for-bit.

Usage:  python scripts/refcheck/run_parity.py [--words N] [--out FILE]

Writes a JSON record (default docs/refcheck_parity.json) with per-method
MATCH plus mismatch statistics.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

from common import write_profile  # noqa: E402  (shared Profile template)

import jax

# CPU: this host's role is driving the reference binary (AVX-512).
jax.config.update("jax_platforms", "cpu")

from faid.code.qc_matrix import load_code  # noqa: E402
from faid.config import (DecodeMethod, DecoderConfig,  # noqa: E402
                             FaidLutFamily)
from faid.decoders.core import build_decoder  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[2]
BUILD = REPO / ".refbuild"
N_VAR, N_INFO, N_CHK = 17664, 14592, 3072

# Per-method (factor_1, factor_2, lut_family): the reference sweep
# default 1/6 for all but NMS, whose (min*factor)>>5 normalization
# floors to zero at 1/6 (docs/VALIDATION.md) - NMS additionally runs at
# its sensible 26/32 so both degenerate and realistic datapaths are
# pinned.  FAID+DTBF runs once per LUT family (the reference's #define
# FAID3/FAID32/FAID2, CDecoder_FAID.cpp:8-127; build.sh compiles one
# harness binary per family).
CASES = [
    (DecodeMethod.NMS, 26, 32, None),
    (DecodeMethod.NMS, 1, 6, None),
    (DecodeMethod.OMS, 1, 6, None),
    (DecodeMethod.FAID_DTBF, 1, 6, FaidLutFamily.FAID3),
    (DecodeMethod.FAID_DTBF, 1, 6, FaidLutFamily.FAID32),
    (DecodeMethod.FAID_DTBF, 1, 6, FaidLutFamily.FAID2),
    (DecodeMethod.OMS_BF, 1, 6, None),
    (DecodeMethod.OMS_DTBF, 1, 6, None),
    (DecodeMethod.FAID_2B1C, 1, 6, None),
]

HARNESS_FOR_LUT = {
    None: "refharness",
    FaidLutFamily.FAID3: "refharness",
    FaidLutFamily.FAID32: "refharness_faid32",
    FaidLutFamily.FAID2: "refharness_faid2",
}



def make_llr_words(n_words: int, rng: np.random.Generator) -> np.ndarray:
    """[n_words, 32, 17664] int8 in the 4-bit range +/-7: all-zero
    codeword BPSK at mixed SNRs (realistic error patterns) plus one word
    of uniform-random LLRs (adversarial)."""
    words = []
    scale = 13.0
    for w in range(n_words):
        if w % 4 == 3:
            llr = rng.integers(-7, 8, size=(32, N_VAR), dtype=np.int8)
        else:
            snr_db = [3.2, 3.6, 4.0][w % 3]
            rate = 0.8444444
            sigma = 1.0 / np.sqrt(rate * 2 * 10 ** (snr_db / 10))
            # all-zero codeword -> BPSK symbol -1.0
            y = -1.0 + sigma * rng.standard_normal((32, N_VAR))
            q = np.round(y * scale)
            llr = np.clip(q, -7, 7).astype(np.int8)
        words.append(llr)
    return np.stack(words)


def ref_decode(method: int, max_iter: int, f1: int, f2: int,
               words: np.ndarray, workdir: pathlib.Path,
               harness: str = "refharness") -> np.ndarray:
    """Run the reference harness; returns hard bits [n_words, 32, n_var]."""
    write_profile(workdir, method, f1, f2, max_iter=max_iter)
    # fixInput layout: [32 x info frame-major][32 x check frame-major]
    blobs = []
    for w in words:
        blobs.append(w[:, :N_INFO].tobytes())
        blobs.append(w[:, N_INFO:].tobytes())
    inp = workdir / "llr.bin"
    out = workdir / "hard.bin"
    inp.write_bytes(b"".join(blobs))
    subprocess.run(
        [str(BUILD / harness), "decode", str(method), str(max_iter),
         str(len(words)), str(inp), str(out)],
        cwd=workdir, check=True)
    hard = np.frombuffer(out.read_bytes(), dtype=np.int8)
    return hard.reshape(len(words), 32, N_VAR)


def jax_decode(method: DecodeMethod, max_iter: int, f1: int, f2: int,
               words: np.ndarray, lut=None) -> np.ndarray:
    code = load_code("50gpon")
    dcfg = DecoderConfig.for_method(method, max_iter=max_iter,
                                    factor_1=f1, factor_2=f2,
                                    lut_family=lut, stop_mode="group")
    decode = jax.jit(build_decoder(code, dcfg))
    outs = []
    for w in words:  # one 32-frame word at a time = one reference group
        outs.append(np.asarray(decode(w)["hard"], dtype=np.int8))
    return np.stack(outs)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--words", type=int, default=4,
                    help="32-frame words per method")
    ap.add_argument("--max-iter", type=int, default=6)
    ap.add_argument("--seed", type=int, default=20260817)
    ap.add_argument("--out", default=str(REPO / "docs/refcheck_parity.json"))
    args = ap.parse_args()

    if not (BUILD / "refharness").exists():
        subprocess.run(["bash", str(REPO / "scripts/refcheck/build.sh")],
                       check=True)

    rng = np.random.default_rng(args.seed)
    results = []
    ok_all = True
    with tempfile.TemporaryDirectory() as td:
        wd = pathlib.Path(td)
        for method, f1, f2, lut in CASES:
            words = make_llr_words(args.words, rng)
            ref = ref_decode(int(method), args.max_iter, f1, f2, words, wd,
                             harness=HARNESS_FOR_LUT[lut])
            got = jax_decode(method, args.max_iter, f1, f2, words, lut=lut)
            mism = int((ref != got).sum())
            frames_bad = int(((ref != got).any(axis=2)).sum())
            rec = {
                "method": int(method), "name": method.name,
                "factor_1": f1, "factor_2": f2,
                "lut_family": lut.value if lut else None,
                "frames": int(words.shape[0] * 32),
                "bits_compared": int(ref.size),
                "mismatched_bits": mism,
                "mismatched_frames": frames_bad,
                "match": mism == 0,
            }
            ok_all &= rec["match"]
            results.append(rec)
            fam = f" [{lut.value}]" if lut else ""
            print(f"{method.name:12s} f={f1}/{f2}{fam}  "
                  f"{'MATCH' if rec['match'] else 'MISMATCH'}  "
                  f"({rec['frames']} frames, {mism} bad bits, "
                  f"{frames_bad} bad frames)")

    record = {"seed": args.seed, "max_iter": args.max_iter,
              "all_match": ok_all, "cases": results}
    pathlib.Path(args.out).write_text(json.dumps(record, indent=1) + "\n")
    print(f"wrote {args.out}; all_match={ok_all}")
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
