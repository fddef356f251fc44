"""Reference-binary FER curve generation (VERDICT round 1, item 1b).

Runs the compiled reference decoders through a full Monte-Carlo chain
(FakeEncoder all-zero codeword -> QPSK -> AWGN -> reference demod ->
reference 4-bit quantizer -> reference decoder -> reference
CalculateErrors) via scripts/refcheck/harness.cpp `fer` mode, and writes
docs/refcheck_fer.json.

The RNG is std::mt19937 (the documented deviation: statistical
equivalence, not MKL stream parity); everything downstream of the noise
draw is the reference's own code.  Compare with faid's measured FER
using scripts/refcheck/compare_fer.py.

The POINTS matrix covers every Profile.txt knob: all six methods (QPSK
scale 13), BPSK's factor-2 sigma convention, 16/64-QAM with interleave
depth 2, 256-QAM, hybrid scale 12.5, and the FAID32/FAID2 LUT families
at their paper scales (13/14).

Usage: python scripts/refcheck/run_fer.py [--only 14,15,16]
         [--min-errors 50] [--max-rounds 40000] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import pathlib
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

REPO = pathlib.Path(__file__).resolve().parents[2]
BUILD = REPO / ".refbuild"
RATE = 0.8444444

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from common import write_profile  # noqa: E402  (shared Profile template)


METHOD_NAMES = ["NMS", "OMS", "FAID_DTBF", "OMS_BF", "OMS_DTBF",
                "FAID_2B1C"]

HARNESS_FOR_LUT = {"faid3": "refharness", "faid32": "refharness_faid32",
                   "faid2": "refharness_faid2"}

# The anchor matrix (VERDICT r2 item 2): every Profile.txt knob the
# reference exposes gets at least one end-to-end statistical anchor.
# Fields: (method, f1, f2, snr_db, mod_type, depth, scale, lut).
# SNRs sit in each config's waterfall (docs/VALIDATION.md) so the
# stopping rule converges in minutes of reference CPU time.
BASE = [(m, 1, 6) for m in range(6)] + [(0, 26, 32)]
POINTS = (
    # the round-2 core: all six methods, QPSK, scale 13, 3.6 + 3.8 dB
    [(m, f1, f2, snr, 2, 1, 13.0, "faid3")
     for (m, f1, f2) in BASE for snr in (3.6, 3.8)]
    + [
        # BPSK (mod 1): pins the extra factor-2 sigma convention
        # (reference CSimulate.cpp:70-74) and the no-interleaver branch.
        (2, 1, 6, 3.6, 1, 1, 13.0, "faid3"),
        (2, 1, 6, 3.8, 1, 1, 13.0, "faid3"),
        (4, 1, 6, 3.6, 1, 1, 13.0, "faid3"),
        # 16-QAM, interleave depth 2 (CModulate.cpp:95-212 + :270-310).
        # NOTE: FakeEncoder's all-zero codeword maps every rail to an
        # inner constellation point, so its waterfall sits ~0.6 dB right
        # of the random-codeword curve in docs/VALIDATION.md.
        (2, 1, 6, 8.0, 4, 2, 13.0, "faid3"),
        (2, 1, 6, 8.2, 4, 2, 13.0, "faid3"),
        # 64-QAM, depth 2 (CModulate.cpp:311-341).
        (4, 1, 6, 14.0, 6, 2, 13.0, "faid3"),
        # 256-QAM, depth 1 (CModulate.cpp:342-362).
        (4, 1, 6, 18.6, 8, 1, 13.0, "faid3"),
        # hybrid-precision scale 12.5 (README.md:20).
        (5, 1, 6, 3.6, 2, 1, 12.5, "faid3"),
        (5, 1, 6, 3.8, 2, 1, 12.5, "faid3"),
        # LUT family FAID32 (scale 13) and FAID2 (scale 14, README:20).
        (2, 1, 6, 3.6, 2, 1, 13.0, "faid32"),
        (2, 1, 6, 3.8, 2, 1, 13.0, "faid32"),
        (2, 1, 6, 3.8, 2, 1, 14.0, "faid2"),
        (2, 1, 6, 4.0, 2, 1, 14.0, "faid2"),
        # Floor-entrance anchors (round 4): FER ~1e-6 - the regime where
        # the paper's error-floor story lives and where the DTBF
        # post-processor dominates the outcome.  ~5M reference frames
        # per row (chunks fan out over all cores).
        (2, 1, 6, 3.9, 2, 1, 13.0, "faid3"),
        (4, 1, 6, 3.9, 2, 1, 13.0, "faid3"),
        # Round-5 thickening (VERDICT r4 item 3): a second, lower-FER
        # point per high-order modulation (waterfall mid-slope ~1e-3;
        # the 14.0/18.6 dB rows sit at the waterfall top), and one
        # depth-3 end-to-end row (CModulate.cpp:95-212 depth-D loop;
        # depths 1/2 were already anchored e2e, depth 3 only at the
        # component level).
        (4, 1, 6, 15.0, 6, 2, 13.0, "faid3"),   # 64-QAM mid-waterfall
        (4, 1, 6, 19.2, 8, 1, 13.0, "faid3"),   # 256-QAM mid-waterfall
        (2, 1, 6, 8.2, 4, 3, 13.0, "faid3"),    # 16-QAM, depth 3
        # Floor-entrance anchors for the remaining BF post-processors
        # (FAID_DTBF and OMS_DTBF were anchored there in round 4).
        # OMS_BF's cliff is steeper than the others': 3.9 dB measured
        # 7.8e-8 (1 error / 12.8M reference frames - hours per decent
        # error count), so its anchor sits at 3.85 dB (~1e-6).
        (3, 1, 6, 3.85, 2, 1, 13.0, "faid3"),   # OMS_BF
        (5, 1, 6, 3.9, 2, 1, 13.0, "faid3"),    # FAID_2B1C
    ]
)


def sigma_at(snr_db: float, mod_type: int = 2) -> float:
    """Reference CSimulate.cpp:67-91; BPSK has the extra factor 2."""
    extra = 2.0 if mod_type == 1 else 1.0
    return 1.0 / math.sqrt(extra * RATE * mod_type * 10 ** (snr_db / 10))


def run_point(wd, method, f1, f2, snr, min_errors, max_rounds, seed,
              mod_type=2, depth=1, scale=13.0, lut="faid3", chunk=500):
    """One anchor point.  Harness invocations are single-threaded (the
    reference's pthread fan-out lives in main.cpp, which the harness
    bypasses), so chunks with distinct seeds fan out over every core -
    the same shared-nothing per-seed decomposition the reference's
    thread model uses (main.cpp:31-34)."""
    write_profile(wd, method, f1, f2)
    harness = BUILD / HARNESS_FOR_LUT[lut]
    sigma = sigma_at(snr, mod_type)
    frames = errors = bits = lt3 = 0
    t0 = time.monotonic()
    rounds_done = 0
    workers = max(1, os.cpu_count() or 1)

    def one_chunk(offset):
        r = subprocess.run(
            [str(harness), "fer", str(method), "6",
             f"{sigma:.9f}", f"{scale:g}", str(chunk),
             str(seed + offset), str(mod_type), str(depth)],
            cwd=wd, check=True, capture_output=True, text=True)
        return json.loads(r.stdout)

    with ThreadPoolExecutor(max_workers=workers) as pool:
        while (errors < min_errors and rounds_done < max_rounds):
            offs = [rounds_done + k * chunk for k in range(workers)]
            offs = [o for o in offs if o < max_rounds]
            for out in pool.map(one_chunk, offs):
                frames += out["test_frames"]
                errors += out["error_frames"]
                bits += out["error_bits"]
                lt3 += out["lt3_frames"]
            rounds_done = offs[-1] + chunk
    dt = time.monotonic() - t0
    return {
        "method": METHOD_NAMES[method], "snr_db": snr,
        "factor_1": f1, "factor_2": f2,
        "mod_type": mod_type, "depth": depth, "scale": scale, "lut": lut,
        "frames": frames, "error_frames": errors,
        "fer": errors / max(frames, 1),
        "ber": bits / max(frames, 1) / 14592,
        "lt3_frames": lt3, "seconds": round(dt, 1),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--min-errors", type=int, default=50)
    ap.add_argument("--max-rounds", type=int, default=40000)
    ap.add_argument("--seed", type=int, default=424242)
    ap.add_argument("--only", default=None,
                    help="comma list of row indices into POINTS to run "
                         "(default: all; merges into --out)")
    ap.add_argument("--out", default=str(REPO / "docs/refcheck_fer.json"))
    args = ap.parse_args()

    if not (BUILD / "refharness_faid2").exists():
        subprocess.run(["bash", str(REPO / "scripts/refcheck/build.sh")],
                       check=True)

    todo = list(range(len(POINTS)))
    if args.only:
        todo = [int(i) for i in args.only.split(",")]
    out_path = pathlib.Path(args.out)
    rows = []
    if args.only and out_path.exists():
        rows = json.loads(out_path.read_text())

    def rowkey(r):
        return (r["method"], r["snr_db"], r["factor_1"], r["factor_2"],
                r.get("mod_type", 2), r.get("depth", 1),
                r.get("scale", 13.0), r.get("lut", "faid3"))

    with tempfile.TemporaryDirectory() as td:
        wd = pathlib.Path(td)
        for i in todo:
            m, f1, f2, snr, mod, depth, scale, lut = POINTS[i]
            row = run_point(wd, m, f1, f2, snr, args.min_errors,
                            args.max_rounds, args.seed, mod_type=mod,
                            depth=depth, scale=scale, lut=lut)
            rows = [r for r in rows if rowkey(r) != rowkey(row)] + [row]
            print(f"{row['method']:10s} {snr:g} dB f={f1}/{f2} "
                  f"mod={mod} d={depth} s={scale:g} {lut}  "
                  f"FER {row['fer']:.3e} "
                  f"({row['error_frames']}/{row['frames']}) "
                  f"{row['seconds']}s", flush=True)
            out_path.write_text(json.dumps(rows, indent=1) + "\n")
    print(f"wrote {args.out} ({len(rows)} rows)")


if __name__ == "__main__":
    sys.exit(main())
