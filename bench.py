#!/usr/bin/env python
"""Headline benchmark: decoded info-bit throughput (Mbit/s per device) of
the full Monte-Carlo pipeline (QPSK -> AWGN -> demap -> 4-bit quantize ->
FAID+DTBF decode -> stats) on the 50G-PON code - the reference's default
Profile.txt configuration (QPSK, DecodeMethod 2, 6 MP iterations)
measured at 4.0 dB.

Each call runs ``--rounds`` Monte-Carlo rounds inside one on-device
``lax.fori_loop``; ``--calls`` such calls are timed together and end in
``block_until_ready`` on their counters.

Runs on a GPU only: without one it exits non-zero before compiling.

Prints the device on one line, then ONE JSON line:
  {"metric": ..., "value": N, "unit": "Mbit/s", "platform": ..., ...}
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=2048,
                    help="frames per round (per device)")
    ap.add_argument("--rounds", type=int, default=25,
                    help="Monte-Carlo rounds per on-device loop call")
    ap.add_argument("--calls", type=int, default=8,
                    help="loop calls timed together")
    ap.add_argument("--snr", type=float, default=4.0)
    ap.add_argument("--method", type=int, default=2)
    ap.add_argument("--channel", type=str, default="fused",
                    choices=["xla", "fused"],
                    help="channel law (fused = quantile staircase, "
                         "statistically validated vs the float chain: "
                         "tests/test_pallas_channel.py, "
                         "scripts/channel_parity.py)")
    ap.add_argument("--stop-mode", default="group",
                    choices=["frame", "group"],
                    help="early-stop granularity (default 'group' = the "
                         "reference's 32-frame-word semantics; 'frame' = "
                         "per-frame freeze)")
    ap.add_argument("--encode", default="fake",
                    choices=["fake", "random"],
                    help="'fake' (default) = all-zero codeword, the "
                         "reference's own default run path (FAKE_ENCODE, "
                         "CSimulate.cpp:4,103); 'random' = random messages "
                         "through the GF(2) encoder (a workload the "
                         "reference cannot run - its GenMatrix blobs are "
                         "missing)")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    n_dev = len(jax.devices())
    print(f"# platform={dev.platform} device_kind={dev.device_kind} "
          f"device_count={n_dev}", flush=True)
    if dev.platform != "gpu":
        print("bench.py measures a GPU; JAX found none", file=sys.stderr)
        return 1

    from faid.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    from faid.code.qc_matrix import load_code
    from faid.config import DecodeMethod, SimConfig
    from faid.sim.pipeline import build_sim_loop

    code = load_code("50gpon")
    cfg = SimConfig(decode_method=DecodeMethod(args.method),
                    max_iteration=6, mod_type=2,
                    batch_per_device=args.batch, seed=0,
                    stop_mode=args.stop_mode,
                    fake_encode=args.encode == "fake",
                    channel_backend=args.channel)
    loop = jax.jit(build_sim_loop(code, cfg, args.rounds))
    sigma = jnp.float32(cfg.sigma_at(args.snr))
    key = jax.random.key(0)

    t0 = time.perf_counter()
    jax.block_until_ready(loop(key, sigma, jnp.int32(0)))
    compile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    outs = [loop(key, sigma, jnp.int32((c + 1) * args.rounds))
            for c in range(args.calls)]
    jax.block_until_ready(outs)
    dt = time.perf_counter() - t0
    out = jax.tree.map(lambda *xs: sum(xs), *jax.device_get(outs))

    frames = args.batch * args.rounds * args.calls
    if int(out["test_frames"]) != frames:
        print(f"counted {int(out['test_frames'])} frames, ran {frames}",
              file=sys.stderr)
        return 1
    mbit_s = frames * code.n_info / dt / 1e6
    print(json.dumps({
        "metric": f"decoded_info_throughput_{cfg.decode_method.name.lower()}"
                  f"_qpsk_{args.snr:g}dB",
        "value": mbit_s,
        "unit": "Mbit/s",
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": n_dev,
        "encode": args.encode,
        "channel": args.channel,
        "stop_mode": args.stop_mode,
        "batch": args.batch,
        "frames": frames,
        "wall_s": dt,
        "compile_and_first_call_s": compile_s,
        "error_frames": int(out["error_frames"]),
        "avg_mp_iters": int(out["mp_iters"]) / frames,
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
