"""Statistical FER comparison: compiled reference binary vs faid.

For every row of docs/refcheck_fer.json (produced by run_fer.py from the
reference's own demod -> quantize -> decode -> CalculateErrors chain),
run the faid pipeline at the same operating point - same method,
factors, SNR, QPSK all-zero codeword, 6 MP iterations, scale 13 - with
``stop_mode='group'`` (the reference's 32-frame SIMD-word early-stop
granularity) until a comparable error count is reached, then compare the
two FER estimates with a two-proportion z-test.

The noise RNGs differ by design (std::mt19937 scalar draws vs threefry;
README "Fidelity contract"), so the claim being tested is STATISTICAL
equality of the end-to-end frame-error probability, not bit parity (bit
parity on identical inputs is tests/test_refbinary.py).  |z| < 4 at
every point = the two implementations sample the same FER within Monte
Carlo resolution.

Also re-runs each point with ``stop_mode='frame'`` so the group-vs-frame
early-stop deviation is a measured delta, not an assertion.

Usage: python scripts/refcheck/compare_fer.py
         [--ref docs/refcheck_fer.json] [--out docs/refcheck_fer_compare]
         [--batch 512] [--max-frames 2000000]
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))


def run_point(code, rr, stop_mode, batch,
              target_errors, max_frames, seed):
    import zlib

    import jax
    import jax.numpy as jnp

    from faid.config import DecodeMethod, SimConfig
    from faid.sim.pipeline import build_sim_loop

    method = rr["_method"]
    cfg = SimConfig(decode_method=DecodeMethod(method), max_iteration=6,
                    mod_type=rr.get("mod_type", 2),
                    interleave_depth=rr.get("depth", 1),
                    scale=rr.get("scale", 13.0),
                    faid_lut=rr.get("lut", "faid3"),
                    batch_per_device=batch, seed=seed,
                    factor_1=rr["factor_1"], factor_2=rr["factor_2"],
                    stop_mode=stop_mode, fake_encode=True)
    rounds = 4
    loop = jax.jit(build_sim_loop(code, cfg, rounds))
    sigma = jnp.float32(cfg.sigma_at(rr["snr_db"]))
    # Deterministic per-point stream separation (a str hash would be
    # PYTHONHASHSEED-randomized across processes).
    point_id = zlib.crc32(
        f"{method}/{rr['factor_1']}/{rr['factor_2']}/{rr['snr_db']}/"
        f"{cfg.mod_type}/{cfg.interleave_depth}/{cfg.scale}/"
        f"{cfg.faid_lut}/{stop_mode}".encode()) & 0x7FFFFFFF
    key = jax.random.fold_in(jax.random.key(seed), point_id)
    # Warm-up call: compile stays out of the timed region.
    jax.device_get(
        loop(jax.random.fold_in(key, 0xFFFFFFFF), sigma, jnp.int32(1 << 20)))
    c = {"test_frames": 0, "error_frames": 0, "error_bits": 0}
    t0 = time.monotonic()
    rnd = 0
    while c["error_frames"] < target_errors and c["test_frames"] < max_frames:
        out = jax.device_get(loop(key, sigma, jnp.int32(rnd)))
        for k in c:
            c[k] += int(out[k])
        rnd += rounds
    return c, time.monotonic() - t0


def ztest(e1, n1, e2, n2):
    """Two-proportion z statistic; None when either side has no errors."""
    if min(n1, n2) == 0 or e1 + e2 == 0:
        return None
    p = (e1 + e2) / (n1 + n2)
    se = math.sqrt(p * (1 - p) * (1 / n1 + 1 / n2))
    if se == 0:
        return None
    return (e1 / n1 - e2 / n2) / se


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ref", default=str(REPO / "docs/refcheck_fer.json"))
    ap.add_argument("--out", default=str(REPO / "docs/refcheck_fer_compare"))
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--max-frames", type=int, default=2_000_000)
    ap.add_argument("--seed", type=int, default=20260817)
    # Threshold rationale: the z statistics are approximately standard
    # normal under H0 (identical FER), and the matrix has ~33 rows, so
    # the familywise false-alarm rate at |z| < 3 is about
    # 33 * 2*(1-Phi(3)) ~ 9% - one spurious flag per ~11 full reruns -
    # while a real implementation bias at any anchored operating point
    # reproduces on rerun and grows with frames.  (Round 4 used 4;
    # tightened to 3 after the thin faid2 row was re-measured at 4x
    # frames, VERDICT r4 item 3.)
    ap.add_argument("--z-threshold", type=float, default=3.0)
    ap.add_argument("--target-cap", type=int, default=200,
                    help="cap on the per-row faid error target "
                         "(target = max(50, min(cap, ref_error_frames)))")
    args = ap.parse_args()

    from faid.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    from faid.code.qc_matrix import load_code
    from faid.config import DecodeMethod

    code = load_code("50gpon")
    ref_rows = json.loads(Path(args.ref).read_text())
    name_to_m = {m.name: m.value for m in DecodeMethod}

    def rowkey(r):
        return (r["method"], r["snr_db"], r["factor_1"], r["factor_2"],
                r.get("mod_type", 2), r.get("depth", 1),
                r.get("scale", 13.0), r.get("lut", "faid3"))

    # Resume support: completed rows in an existing out-file are kept
    # (each row is written as soon as it finishes - a killed run loses
    # at most the in-flight row).
    done = {}
    if Path(args.out + ".json").exists():
        for r in json.loads(Path(args.out + ".json").read_text())["rows"]:
            if "frame_fer" in r and rowkey(r) in {rowkey(x) for x in ref_rows}:
                # Rows cached from a pre-matrix artifact lack the newer
                # operating-point keys; backfill the defaults they ran at.
                for k, dv in (("mod_type", 2), ("depth", 1),
                              ("scale", 13.0), ("lut", "faid3")):
                    r.setdefault(k, dv)
                done[rowkey(r)] = r

    out_rows, all_ok = [], True
    for rr in ref_rows:
        rr = dict(rr)
        rr["_method"] = name_to_m[rr["method"]]
        f1, f2 = rr["factor_1"], rr["factor_2"]
        snr = rr["snr_db"]
        if rowkey(rr) in done:
            res = done[rowkey(rr)]
            all_ok &= res["consistent"]
            out_rows.append(res)
            print(f"{rr['method']:10s} {snr:g} dB (cached row)",
                  flush=True)
            continue
        # Enough errors for the z-test to have teeth; deep points are
        # bounded by max-frames.
        target = max(50, min(args.target_cap, rr["error_frames"]))
        res = {"method": rr["method"], "snr_db": snr,
               "factor_1": f1, "factor_2": f2,
               "mod_type": rr.get("mod_type", 2),
               "depth": rr.get("depth", 1),
               "scale": rr.get("scale", 13.0),
               "lut": rr.get("lut", "faid3"),
               "ref_fer": rr["fer"], "ref_frames": rr["frames"],
               "ref_error_frames": rr["error_frames"]}
        for mode in ("group", "frame"):
            c, dt = run_point(code, rr, mode,
                              args.batch, target, args.max_frames,
                              args.seed)
            fer = c["error_frames"] / max(c["test_frames"], 1)
            res[f"{mode}_fer"] = fer
            res[f"{mode}_frames"] = c["test_frames"]
            res[f"{mode}_error_frames"] = c["error_frames"]
            res[f"{mode}_seconds"] = round(dt, 1)
        z = ztest(res["ref_error_frames"], res["ref_frames"],
                  res["group_error_frames"], res["group_frames"])
        res["z_group_vs_ref"] = None if z is None else round(z, 2)
        res["consistent"] = z is None or abs(z) < args.z_threshold
        all_ok &= res["consistent"]
        out_rows.append(res)
        print(f"{rr['method']:10s} {snr:g} dB f={f1}/{f2} "
              f"mod={res['mod_type']} d={res['depth']} s={res['scale']:g} "
              f"{res['lut']}  "
              f"ref {rr['fer']:.3e}  group {res['group_fer']:.3e} "
              f"(z={res['z_group_vs_ref']})  frame {res['frame_fer']:.3e}  "
              f"{'OK' if res['consistent'] else 'DIVERGENT'}", flush=True)
        Path(args.out + ".json").write_text(json.dumps(
            {"all_consistent": all_ok, "z_threshold": args.z_threshold,
             "rows": out_rows}, indent=1) + "\n")

    rec = {"all_consistent": all_ok, "z_threshold": args.z_threshold,
           "rows": out_rows}
    Path(args.out + ".json").write_text(json.dumps(rec, indent=1) + "\n")

    lines = [
        "# Reference-binary FER vs faid (statistical parity)\n\n",
        "Same operating point per row (all-zero codeword, 6 MP "
        "iterations, 4-bit LLRs; mod/depth/scale/LUT-family per row); "
        "reference decodes via its own "
        "compiled AVX code (scripts/refcheck/run_fer.py), faid via "
        "this framework with stop_mode='group' (the reference's 32-frame "
        "early-stop granularity). z = two-proportion z-test group-vs-ref; "
        "'frame' columns show the per-frame early stop for "
        "the measured deviation.\n\n",
        "| method | SNR | factors | mod | depth | scale | lut "
        "| ref FER (frames) | group FER (frames) "
        "| z | frame FER (frames) | consistent |\n",
        "|---|---|---|---|---|---|---|---|---|---|---|---|\n",
    ]
    for r in out_rows:
        lines.append(
            f"| {r['method']} | {r['snr_db']:g} | "
            f"{r['factor_1']}/{r['factor_2']} | "
            f"{r['mod_type']} | {r['depth']} | {r['scale']:g} | "
            f"{r['lut']} | "
            f"{r['ref_fer']:.3e} ({r['ref_frames']}) | "
            f"{r['group_fer']:.3e} ({r['group_frames']}) | "
            f"{r['z_group_vs_ref']} | "
            f"{r['frame_fer']:.3e} ({r['frame_frames']}) | "
            f"{'yes' if r['consistent'] else 'NO'} |\n")
    Path(args.out + ".md").write_text("".join(lines))
    print(f"wrote {args.out}.json/.md  all_consistent={all_ok}")
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
