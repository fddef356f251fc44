#!/usr/bin/env python
"""Device time of XLA's MP decode on the full 50G-PON code, from a
``jax.profiler`` trace, and its share of the HBM bandwidth bound.

Decodes one batch of waterfall LLRs (3.6 dB, float chain, all-zero
codeword, group stop) with two configurations of the reference's
default decoder (FAID+DTBF, 6 MP iterations):

  round     the decoder as the Monte-Carlo round runs it (early stop +
            DTBF tail)
  mp6       MP only, exactly 6 iterations (no early stop, no BF), so
            per-iteration device time = time / 6

For each: host wall time per call (block_until_ready), device busy time
per call and the device's idle share in the traced window (union of the
GPU plane's kernel intervals), the kernels that take the most time, and
XLA's own cost analysis.  The bandwidth share divides the bytes an MP
iteration cannot avoid moving - read and write every int8 message and
VN value once, 2 * (70400 + 17664) B per frame - by the iteration's
device time and by the card's peak (table below).

Runs on a GPU only.

    python scripts/decode_profile.py [--batch 2048] [--out FILE]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

# Peak device-memory bandwidth by device_kind (NVIDIA H100 SXM data
# sheet: 80 GB HBM3 at 3.35 TB/s).
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def busy_ns(intervals):
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def reduce_trace(trace_dir):
    """GPU kernel intervals of the newest trace under ``trace_dir`` ->
    (busy ns, window ns, {kernel: [count, total ns]}, line names)."""
    import jax

    path = max(Path(trace_dir).rglob("*.xplane.pb"),
               key=lambda p: p.stat().st_mtime)
    prof = jax.profiler.ProfileData.from_file(str(path))
    intervals, kernels, lines = [], {}, set()
    for plane in prof.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            lines.add(f"{plane.name}:{line.name}")
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                intervals.append((ev.start_ns, ev.end_ns))
                k = kernels.setdefault(ev.name, [0, 0])
                k[0] += 1
                k[1] += ev.duration_ns
    if not intervals:
        raise RuntimeError(f"no GPU kernel events in {path}; lines: "
                           f"{sorted(lines)}")
    window = max(e for _, e in intervals) - min(s for s, _ in intervals)
    return busy_ns(intervals), window, kernels, sorted(lines)


def measure(name, fn, llr, reps, trace_root):
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(llr).compile()
    compile_s = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(llr))           # warm
    t0 = time.perf_counter()
    for _ in range(reps):
        out = compiled(llr)
    jax.block_until_ready(out)
    wall = (time.perf_counter() - t0) / reps

    trace_dir = Path(trace_root) / name
    with jax.profiler.trace(str(trace_dir)):
        for _ in range(reps):
            out = compiled(llr)
        jax.block_until_ready(out)
    busy, window, kernels, lines = reduce_trace(trace_dir)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:12]
    cost = compiled.cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    out = jax.device_get(out)
    return {
        "compile_s": compile_s,
        "wall_s_per_call": wall,
        "device_busy_s_per_call": busy / reps / 1e9,
        "idle_share_in_trace": 1.0 - busy / window,
        "kernel_launches_per_call": sum(v[0] for v in kernels.values())
        / reps,
        "top_kernels": [{"name": k[:120], "count_per_call": v[0] / reps,
                         "s_per_call": v[1] / reps / 1e9}
                        for k, v in top],
        "xla_cost_bytes_accessed": float(cost.get("bytes accessed", -1)),
        "mean_mp_iters": float(out["mp_iters"].mean()),
        "mean_bf_rounds": float(out["bf_rounds"].mean()),
        "trace_lines": lines,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--snr", type=float, default=3.6)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=str(REPO / "chiprun_out"
                                         / "decode_profile.json"))
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print("decode_profile.py measures a GPU; JAX found none",
              file=sys.stderr)
        return 1
    peak = HBM_BYTES_PER_S.get(dev.device_kind)

    from faid.code.qc_matrix import load_code
    from faid.config import BFConfig, DecodeMethod, SimConfig
    from faid.decoders.core import build_decoder
    from faid.sim.pipeline import build_front_end
    from faid.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    code = load_code("50gpon")
    cfg = SimConfig(decode_method=DecodeMethod.FAID_DTBF,
                    batch_per_device=args.batch, fake_encode=True,
                    stop_mode="group")
    cw = jnp.zeros((args.batch, code.n_var), jnp.int8)
    llr, _, _ = jax.jit(build_front_end(code, cfg))(
        cw, jax.random.key(5), jnp.float32(cfg.sigma_at(args.snr)))
    dcfg = cfg.decoder()
    mp6 = dataclasses.replace(dcfg, stop_early=False, bf=BFConfig())

    res = {"device_kind": dev.device_kind, "batch": args.batch,
           "snr_db": args.snr, "hbm_peak_bytes_per_s": peak}
    with tempfile.TemporaryDirectory() as td:
        res["round"] = measure("round", build_decoder(code, dcfg), llr,
                               args.reps, td)
        res["mp6"] = measure("mp6", build_decoder(code, mp6), llr,
                             args.reps, td)
    min_bytes_iter = 2 * (code.n_edges + code.n_var) * args.batch
    t_iter = res["mp6"]["device_busy_s_per_call"] / dcfg.max_iter
    res["mp_iteration"] = {
        "device_s": t_iter,
        "min_bytes": min_bytes_iter,
        "hbm_share_of_min_bytes": (min_bytes_iter / t_iter / peak
                                   if peak else None),
    }
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(res, indent=1) + "\n")
    for k in ("round", "mp6"):
        r = res[k]
        print(f"{k:5s}: compile {r['compile_s']:.1f} s, wall "
              f"{r['wall_s_per_call'] * 1e3:.3f} ms/call, device "
              f"{r['device_busy_s_per_call'] * 1e3:.3f} ms/call, idle "
              f"{r['idle_share_in_trace']:.3f}, launches "
              f"{r['kernel_launches_per_call']:.0f}/call, mean mp_iters "
              f"{r['mean_mp_iters']:.2f}, bf_rounds "
              f"{r['mean_bf_rounds']:.2f}")
    m = res["mp_iteration"]
    if peak is None:
        print(f"no peak bandwidth on record for {dev.device_kind!r}; "
              f"add it to HBM_BYTES_PER_S", file=sys.stderr)
        return 1
    print(f"MP iteration: {m['device_s'] * 1e3:.3f} ms device, "
          f"{m['min_bytes'] / 1e6:.1f} MB minimum traffic -> "
          f"{m['hbm_share_of_min_bytes']:.4f} of {peak / 1e12:.2f} TB/s")
    print(json.dumps({"device_kind": dev.device_kind,
                      "round_device_ms": res["round"]
                      ["device_busy_s_per_call"] * 1e3,
                      "mp_iteration_device_ms": m["device_s"] * 1e3,
                      "hbm_share": m["hbm_share_of_min_bytes"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
