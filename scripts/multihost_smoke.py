"""Multi-host (DCN) smoke worker: one process of an N-process
``jax.distributed`` run on CPU devices.

The reference has no cluster support (SURVEY.md §5: stats are reduced
serially after pthread_join); faid's multi-host contract is that the
same psum-over-mesh reduction used on one host (parallel/mesh.py) also
spans hosts once ``jax.distributed.initialize`` has run (cli.py
--multihost).

This worker initializes the distributed runtime with a loopback
coordinator, builds the global mesh over all hosts' virtual CPU devices,
runs one sharded Monte-Carlo loop on the toy code, and prints the
(replicated, psum-reduced) counters as JSON.  All processes must print
identical counters.  Driven by tests/test_multihost.py and by
``python scripts/multihost_smoke.py --launch N`` standalone.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def worker(args) -> int:
    # Replace (not append to) any inherited device-count flag - pytest's
    # conftest exports its own =8, and duplicate occurrences would leave
    # correctness to last-flag-wins parsing.
    flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
             if not f.startswith("--xla_force_host_platform_device_count")]
    flags.append(
        f"--xla_force_host_platform_device_count={args.local_devices}")
    os.environ["XLA_FLAGS"] = " ".join(flags)
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{args.port}",
        num_processes=args.num_processes,
        process_id=args.process_id,
        local_device_ids=list(range(args.local_devices)),
    )
    import jax.numpy as jnp

    sys.path.insert(0, str(REPO))
    from faid.code.toy import toy_code
    from faid.config import DecodeMethod, SimConfig
    from faid.parallel import mesh as mesh_mod

    assert jax.process_count() == args.num_processes
    assert len(jax.devices()) == args.num_processes * args.local_devices

    code = toy_code()
    cfg = SimConfig(decode_method=DecodeMethod.FAID_DTBF, max_iteration=3,
                    mod_type=2, batch_per_device=8, fake_encode=False,
                    seed=7)
    mesh = mesh_mod.make_mesh()
    loop = mesh_mod.build_sharded_sim_loop(code, cfg, mesh, rounds=2)
    out = loop(jax.random.key(cfg.seed), jnp.float32(0.5), jnp.int32(0))
    out = {k: (v.tolist() if getattr(v, "ndim", 0) else int(v))
           for k, v in jax.device_get(out).items()}
    out["process_id"] = args.process_id
    out["global_devices"] = len(jax.devices())
    print("MULTIHOST_RESULT " + json.dumps(out, sort_keys=True), flush=True)
    jax.distributed.shutdown()
    return 0


def launch(args) -> int:
    procs = []
    for pid in range(args.launch):
        cmd = [sys.executable, __file__, "--port", str(args.port),
               "--num-processes", str(args.launch),
               "--process-id", str(pid),
               "--local-devices", str(args.local_devices)]
        procs.append(subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=REPO))
    outs = [p.communicate(timeout=args.timeout)[0] for p in procs]
    results = []
    for pid, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            print(o)
            print(f"process {pid} failed rc={p.returncode}")
            return 1
        line = [ln for ln in o.splitlines()
                if ln.startswith("MULTIHOST_RESULT ")]
        if not line:
            print(o)
            print(f"process {pid}: no result line")
            return 1
        results.append(json.loads(line[-1].split(" ", 1)[1]))
    base = {k: v for k, v in results[0].items() if k != "process_id"}
    for r in results[1:]:
        if {k: v for k, v in r.items() if k != "process_id"} != base:
            print("MISMATCH:", results)
            return 1
    print("multihost smoke OK:", json.dumps(base, sort_keys=True))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--launch", type=int, default=0,
                    help="launch N worker processes and verify agreement")
    ap.add_argument("--port", type=int, default=29517)
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--local-devices", type=int, default=4)
    ap.add_argument("--timeout", type=int, default=600)
    args = ap.parse_args()
    return launch(args) if args.launch else worker(args)


if __name__ == "__main__":
    sys.exit(main())
