"""Deep error-floor FER campaign on the accelerator.

Runs one or more decode methods at one SNR point, group stop mode (the
reference's 32-frame-word semantics), through the production fused
pipeline until a target error count or a frame budget is reached, and
merges the rows into a JSON artifact (FER, frames and counters; no
times).  docs/FLOOR.md summarizes the campaigns run so far.

Rows with 0 errors are labeled upper bounds: fer_ub95 = 3/frames (the
rule-of-three 95% bound).

Dispatch pattern follows bench.py: ``rounds`` Monte-Carlo rounds per
on-device ``fori_loop`` call, several calls queued per host sync.

Usage: python scripts/floor_campaign.py --methods 3,4,5 --snr 4.0
         [--target-errors 20] [--max-frames 120000000]
         [--out docs/floor_group_40.json]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--methods", default="3,4,5")
    ap.add_argument("--snr", type=float, default=4.0)
    ap.add_argument("--target-errors", type=int, default=20)
    ap.add_argument("--max-frames", type=int, default=120_000_000)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--rounds", type=int, default=25)
    ap.add_argument("--calls", type=int, default=8)
    ap.add_argument("--stop-mode", default="group",
                    choices=["frame", "group"])
    ap.add_argument("--seed", type=int, default=20260820)
    ap.add_argument("--out", default=str(REPO / "docs/floor_group_40.json"))
    args = ap.parse_args()

    from faid.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    import jax
    import jax.numpy as jnp

    from faid.code.qc_matrix import load_code
    from faid.config import DecodeMethod, SimConfig
    from faid.sim.pipeline import build_sim_loop

    code = load_code("50gpon")
    out_path = Path(args.out)
    rows = json.loads(out_path.read_text()) if out_path.exists() else []

    def rowkey(r):
        return (r["method"], r["snr_db"], r.get("stop_mode", "group"))

    for m in (int(x) for x in args.methods.split(",")):
        method = DecodeMethod(m)
        cfg = SimConfig(decode_method=method, max_iteration=6, mod_type=2,
                        batch_per_device=args.batch, seed=args.seed,
                        stop_mode=args.stop_mode, fake_encode=True,
                        channel_backend="fused")
        loop = jax.jit(build_sim_loop(code, cfg, args.rounds))
        sigma = jnp.float32(cfg.sigma_at(args.snr))
        key = jax.random.fold_in(jax.random.key(args.seed), m)
        # Warm-up compile, discarded.
        jax.device_get(loop(key, sigma, jnp.int32(1 << 24)))

        c = {"test_frames": 0, "error_frames": 0, "error_bits": 0,
             "mp_iters": 0, "bf_rounds": 0}
        t0 = time.monotonic()
        rnd = 0

        def make_row(partial):
            tf = max(c["test_frames"], 1)
            row = {
                "method": method.name, "snr_db": args.snr,
                "stop_mode": args.stop_mode,
                "frames": c["test_frames"],
                "error_frames": c["error_frames"],
                "fer": c["error_frames"] / tf,
                "ber": c["error_bits"] / tf / code.n_info,
                "avg_mp_iters": c["mp_iters"] / tf,
                "avg_bf_rounds": c["bf_rounds"] / tf,
            }
            if c["error_frames"] == 0:
                row["fer_ub95"] = 3.0 / tf  # rule of three
            if partial:
                row["partial"] = True      # run still in flight / killed
            return row

        while (c["error_frames"] < args.target_errors
               and c["test_frames"] < args.max_frames):
            outs = [loop(key, sigma, jnp.int32(rnd + i * args.rounds))
                    for i in range(args.calls)]
            outs = jax.device_get(outs)
            rnd += args.calls * args.rounds
            for o in outs:
                for k in c:
                    c[k] += int(o[k])
            el = time.monotonic() - t0
            print(f"\r{method.name:10s} {args.snr} dB  "
                  f"{c['test_frames']/1e6:.1f}M frames  "
                  f"{c['error_frames']} err  "
                  f"{c['test_frames']*code.n_info/el/1e6:.0f} Mbit/s  "
                  f"{el:.0f}s", end="", flush=True)
            # Checkpoint every batch of calls: a killed or hung run
            # loses at most one dispatch group, not the whole row.
            row = make_row(partial=True)
            out_path.write_text(json.dumps(
                [r for r in rows if rowkey(r) != rowkey(row)] + [row],
                indent=1) + "\n")
        print()
        row = make_row(partial=False)
        rows = [r for r in rows if rowkey(r) != rowkey(row)] + [row]
        out_path.write_text(json.dumps(rows, indent=1) + "\n")
        print(f"{method.name}: FER {row['fer']:.3e} "
              f"({c['error_frames']}/{c['test_frames']})  -> {out_path}")


if __name__ == "__main__":
    main()
