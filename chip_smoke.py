#!/usr/bin/env python
"""Smoke test of the Monte-Carlo main path on the GPU, at full width.

The full 50G-PON code (N=17664, K=14592, 12x69 circulants of Z=256) at
the reference's default Profile (QPSK, depth 1, FAID+DTBF, 6 MP
iterations, scale 13, 4-bit LLRs, group stop), in ONE process so that
one JAX process holds the card.  Phases, in order; the first one that
fails raises and the script exits non-zero without a result line:

  1. device     a GPU is required; prints jax's version, the devices and
                the card's name and power limit (nvidia-smi)
  2. decoder    all six methods on 64 waterfall frames (3.6 dB, float
                chain, drawn on the GPU, stop_mode="frame") vs the C++
                golden model (utils/native_src/golden.cpp): hard bits,
                mp_iters and bf_rounds exactly equal
  3. encoder    256 random messages encoded on the GPU; every codeword's
                syndrome is zero (numpy on the host)
  4. cli        ``faid.cli`` in-process at 3.6 dB, batch 2048, fake
                encode, >= 16384 frames: FER z-consistent (|z| < 3) with
                the reference binary's anchor (docs/refcheck_fer.json),
                Result.txt written, a rerun resumes from checkpoint.json
                with unchanged counters
  5. channel    pre-decoder BER of the quantile staircase vs the float
                chain at 3.6 dB, two-proportion |z| < 6
  6. bench      ``bench.main()`` once, in-process

``--four-cards`` runs only the four-GPU path instead: the sharded loop
on four cards equals the sum of four one-card loops keyed
fold_in(key, d), and the phase-4 CLI point on the four-card mesh.

The last line of stdout is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

    python chip_smoke.py                # one GPU
    python chip_smoke.py --four-cards   # four GPUs
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SNR_DB = 3.6
SMOKE_BATCH = 2048          # bench.py's frames per round per card
MIN_FRAMES = 16384


@contextlib.contextmanager
def phase(name):
    print(f"== phase {name}", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"== phase {name} ok ({time.perf_counter() - t0:.1f} s)",
          flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def compile_all(jobs):
    """{name: (jitted fn, example args)} -> {name: (compiled, seconds)}.

    The full-code programs take minutes each to compile on the GPU, most
    of it single-threaded host work that releases the GIL, so they are
    compiled side by side."""
    from concurrent.futures import ThreadPoolExecutor

    def one(fn_args):
        fn, args = fn_args
        t0 = time.perf_counter()
        compiled = fn.lower(*args).compile()
        return compiled, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        futures = {name: pool.submit(one, job) for name, job in jobs.items()}
        return {name: f.result() for name, f in futures.items()}


def ztest(e1, n1, e2, n2):
    p = (e1 + e2) / (n1 + n2)
    se = math.sqrt(p * (1 - p) * (1 / n1 + 1 / n2))
    return (e1 / n1 - e2 / n2) / se


def require_gpus(n):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke.py needs a GPU; JAX found "
                         f"{devs[0].platform}")
    if len(devs) < n:
        raise SystemExit(f"needs {n} GPUs, JAX found {len(devs)}")
    print(f"jax {jax.__version__}", flush=True)
    print(f"devices {devs}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    for line in smi.stdout.strip().splitlines():
        print(f"nvidia-smi: {line}", flush=True)
    return devs


def reference_anchor():
    rows = json.loads((REPO / "docs" / "refcheck_fer.json").read_text())
    for r in rows:
        if (r["method"] == "FAID_DTBF" and r["snr_db"] == SNR_DB
                and r["mod_type"] == 2 and r["depth"] == 1
                and r["scale"] == 13.0 and r["lut"] == "faid3"
                and (r["factor_1"], r["factor_2"]) == (1, 6)):
            return r["error_frames"], r["frames"]
    raise AssertionError("reference anchor row missing")


def phase_decoder(code):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from faid.config import DecodeMethod, DecoderConfig, SimConfig
    from faid.decoders.core import build_decoder
    from faid.sim.pipeline import build_front_end
    from faid.utils import native

    n_frames = 64
    cfg = SimConfig(batch_per_device=n_frames, fake_encode=True)
    front = jax.jit(build_front_end(code, cfg))
    cw = jnp.zeros((n_frames, code.n_var), jnp.int8)
    llr, _, _ = front(cw, jax.random.key(11),
                      jnp.float32(cfg.sigma_at(SNR_DB)))
    llr_np = np.asarray(llr)
    dcfgs = {}
    for method in DecodeMethod:
        # NMS at its own 26/32 factors: the Profile's 1/6 zeroes every
        # NMS message (decoders/core.py), which would compare nothing.
        f1, f2 = (26, 32) if method == DecodeMethod.NMS else (1, 6)
        dcfgs[method] = DecoderConfig.for_method(
            method, max_iter=6, factor_1=f1, factor_2=f2, stop_mode="frame")
    t0 = time.perf_counter()
    compiled = compile_all({m: (jax.jit(build_decoder(code, d)), (llr,))
                            for m, d in dcfgs.items()})
    print(f"  six decoders compiled side by side in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for method, dcfg in dcfgs.items():
        dec, compile_s = compiled[method]
        t0 = time.perf_counter()
        out = jax.tree.map(np.asarray, dec(llr))
        run_s = time.perf_counter() - t0
        for f in range(n_frames):
            g = native.golden_decode_native(llr_np[f], code, dcfg)
            check(np.array_equal(out["hard"][f].astype(np.uint8), g["hard"]),
                  f"{method.name} frame {f}: hard bits differ")
            check(int(out["mp_iters"][f]) == g["mp_iters"],
                  f"{method.name} frame {f}: mp_iters "
                  f"{int(out['mp_iters'][f])} != {g['mp_iters']}")
            check(int(out["bf_rounds"][f]) == g["bf_rounds"],
                  f"{method.name} frame {f}: bf_rounds "
                  f"{int(out['bf_rounds'][f])} != {g['bf_rounds']}")
        bad = int(out["hard"][:, :code.n_info].any(axis=1).sum())
        print(f"  {method.name:10s} compile {compile_s:6.1f} s  first call "
              f"{run_s:5.2f} s  {n_frames} frames == golden  "
              f"({bad} frame errors, mean mp_iters "
              f"{out['mp_iters'].mean():.2f})", flush=True)


def phase_encoder(code):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from faid.code.encoder import make_encode_fn

    batch = 256
    u = jax.random.bernoulli(jax.random.key(3), 0.5,
                             (batch, code.n_info)).astype(jnp.int8)
    enc = jax.jit(make_encode_fn(code)).lower(u).compile()
    dots = [ln.strip() for ln in enc.as_text().splitlines()
            if "dot(" in ln or "custom_call_target" in ln
            or "__cublas" in ln]
    print("  encoder GEMM lowering:", flush=True)
    for ln in dots[:8]:
        print(f"    {ln[:200]}", flush=True)
    c = np.asarray(enc(u))
    check(np.array_equal(c[:, :code.n_info], np.asarray(u)),
          "encoder is not systematic")
    h = code.h_dense().astype(np.float32)
    synd = (h @ c.T.astype(np.float32)) % 2      # exact: sums <= n_var
    weights = synd.sum(axis=0)
    check(not weights.any(),
          f"{int((weights > 0).sum())} of {batch} codewords have a "
          f"nonzero syndrome")
    print(f"  {batch} codewords, syndrome weight 0 for all", flush=True)


def cli_point(out_dir, batch):
    """Runs the phase-4 CLI command; returns its one result row."""
    from faid import cli

    argv = ["--snr-start", str(SNR_DB), "--snr-end", str(SNR_DB + 0.05),
            "--snr-pass", "0.1", "--batch", str(batch), "--fake-encode",
            "--min-frames", str(MIN_FRAMES), "--out", str(out_dir)]
    check(cli.main(argv) == 0, "cli.main failed")
    ck = json.loads((out_dir / "checkpoint.json").read_text())
    check(len(ck["results"]) == 1, f"expected one SNR row: {ck['results']}")
    return ck["results"][0]["counters"]


def phase_cli(code, n_cards):
    import jax
    import jax.numpy as jnp

    from faid.config import SimConfig
    from faid.parallel import mesh as mesh_mod

    ref_err, ref_frames = reference_anchor()
    with tempfile.TemporaryDirectory() as td:
        out_dir = Path(td)
        t0 = time.perf_counter()
        c = cli_point(out_dir, SMOKE_BATCH)
        run_s = time.perf_counter() - t0
        result_txt = (out_dir / "Result.txt").read_text()
        check(result_txt.count("\n") == 2, f"Result.txt:\n{result_txt}")
        print("  " + result_txt.replace("\n", "\n  ").rstrip(), flush=True)
        frames, errs = c["test_frames"], c["error_frames"]
        check(frames >= MIN_FRAMES, f"only {frames} frames")
        z = ztest(errs, frames, ref_err, ref_frames)
        print(f"  {n_cards} card(s): FER {errs / frames:.4e} ({errs}/{frames})"
              f" vs reference {ref_err / ref_frames:.4e} "
              f"({ref_err}/{ref_frames}): z = {z:+.2f}  "
              f"[sweep incl. compile {run_s:.1f} s]", flush=True)
        check(abs(z) < 3, f"FER not z-consistent with the reference: z={z}")

        t0 = time.perf_counter()
        c2 = cli_point(out_dir, SMOKE_BATCH)
        check(c2 == c, f"resume changed the counters: {c} -> {c2}")
        print(f"  rerun resumed from checkpoint.json with unchanged "
              f"counters ({time.perf_counter() - t0:.1f} s)", flush=True)

    # The sweep's compiled loop (a persistent-cache hit after the run).
    cfg = SimConfig(batch_per_device=SMOKE_BATCH, fake_encode=True,
                    stop_mode="group")
    mesh = mesh_mod.make_mesh()
    loop = mesh_mod.build_sharded_sim_loop(code, cfg, mesh,
                                           cfg.rounds_per_sync)
    compiled = loop.lower(jax.random.key(0), jnp.float32(1.0),
                          jnp.int32(0)).compile()
    print(f"  sim loop memory_analysis: {compiled.memory_analysis()}",
          flush=True)
    for d in jax.devices():
        stats = d.memory_stats() or {}
        print(f"  {d}: peak_bytes_in_use {stats.get('peak_bytes_in_use')}",
              flush=True)


def phase_channel(code):
    import dataclasses

    import jax
    import jax.numpy as jnp

    from faid.config import SimConfig
    from faid.ops.quantile_channel import reduce_mod_stats
    from faid.sim.pipeline import build_front_end

    rounds = 4
    counts = {}
    base = SimConfig(batch_per_device=SMOKE_BATCH, fake_encode=True)
    sigma = jnp.float32(base.sigma_at(SNR_DB))
    cw = jnp.zeros((SMOKE_BATCH, code.n_var), jnp.int8)
    for law in ("xla", "fused"):
        cfg = dataclasses.replace(base, channel_backend=law)
        front = build_front_end(code, cfg)

        @jax.jit
        def mod_errors(key, front=front):
            _, mod_err, _ = front(cw, key, sigma)
            return reduce_mod_stats(mod_err, code.n_info, 2)[0].sum()

        key = jax.random.key(17 if law == "xla" else 18)
        counts[law] = sum(int(mod_errors(jax.random.fold_in(key, r)))
                          for r in range(rounds))
    nbits = rounds * SMOKE_BATCH * code.n_info
    z = ztest(counts["xla"], nbits, counts["fused"], nbits)
    print(f"  pre-decoder BER: float chain {counts['xla'] / nbits:.6e}, "
          f"staircase {counts['fused'] / nbits:.6e} over {nbits} bits "
          f"each: z = {z:+.2f}", flush=True)
    check(abs(z) < 6, f"channel laws differ: z={z}")


def phase_four_cards(code):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from faid.config import SimConfig
    from faid.parallel import mesh as mesh_mod
    from faid.sim.pipeline import build_sim_loop

    cfg = SimConfig(batch_per_device=SMOKE_BATCH, fake_encode=True,
                    stop_mode="group")
    rounds = cfg.rounds_per_sync
    mesh = mesh_mod.make_mesh(jax.devices()[:4])
    key = jax.random.key(21)
    sigma = jnp.float32(cfg.sigma_at(SNR_DB))
    round0 = jnp.int32(8)
    compiled = compile_all({
        "sharded": (mesh_mod.build_sharded_sim_loop(code, cfg, mesh, rounds),
                    (key, sigma, round0)),
        "one": (jax.jit(build_sim_loop(code, cfg, rounds)),
                (key, sigma, round0))})
    (sharded, s_sharded), (one, s_one) = compiled["sharded"], compiled["one"]
    print(f"  compiled side by side: sharded loop {s_sharded:.1f} s, "
          f"one-card loop {s_one:.1f} s", flush=True)
    t0 = time.perf_counter()
    got = jax.device_get(sharded(key, sigma, round0))
    print(f"  sharded loop, 4 cards: {time.perf_counter() - t0:.2f} s",
          flush=True)
    t0 = time.perf_counter()
    want = None
    for d in range(4):
        out = jax.device_get(one(jax.random.fold_in(key, d), sigma, round0))
        want = out if want is None else jax.tree.map(np.add, want, out)
    print(f"  four one-card loops: {time.perf_counter() - t0:.2f} s",
          flush=True)
    for k in want:
        check(np.array_equal(np.asarray(got[k]), np.asarray(want[k])),
              f"counter {k}: sharded {got[k]} != sum {want[k]}")
    print(f"  sharded == sum of one-card loops on all counters "
          f"({int(got['test_frames'])} frames, "
          f"{int(got['error_frames'])} frame errors)", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-GPU path (needs 4 GPUs)")
    args = ap.parse_args(argv)

    with phase("device"):
        devs = require_gpus(4 if args.four_cards else 1)

    from faid.code.qc_matrix import load_code
    from faid.utils.cache import enable_compilation_cache

    # Identical computations compiled twice in this process (the sweep's
    # loop, rebuilt for memory_analysis) hit the cache instead.
    enable_compilation_cache()
    code = load_code("50gpon")

    if args.four_cards:
        with phase("four-card equivalence"):
            phase_four_cards(code)
        with phase("cli on the four-card mesh"):
            phase_cli(code, 4)
    else:
        with phase("decoder parity vs C++ golden"):
            phase_decoder(code)
        with phase("encoder"):
            phase_encoder(code)
        with phase("cli main path"):
            phase_cli(code, 1)
        with phase("channel law"):
            phase_channel(code)
        with phase("bench"):
            import bench

            check(bench.main([]) == 0, "bench.main failed")

    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
