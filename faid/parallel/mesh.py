"""Device-mesh data parallelism for the Monte-Carlo pipeline.

The reference's two parallel axes - 32 frames per SIMD word (CLDPC.h:21)
and one shared-nothing pthread worker per core with a serial ``+=`` stat
reduction after ``pthread_join`` (reference main.cpp:164-182,
CSimulate.cpp:218-278) - collapse into ONE sharded batch axis over a
``jax.sharding.Mesh``.  Each device runs the identical jitted step on its
batch shard with a device-folded RNG key, and the per-step counters are
reduced with ``jax.lax.psum`` - the replacement for the join-barrier
reduction.

Frames are i.i.d., so this is pure data parallelism: no tensor state ever
crosses devices; only the handful of int32 counters do.
"""

from __future__ import annotations

from typing import Callable

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..code.qc_matrix import QCCode
from ..config import SimConfig
from ..sim.pipeline import build_sim_loop, build_sim_step

BATCH_AXIS = "batch"


def make_mesh(devices=None, axis: str = BATCH_AXIS) -> Mesh:
    """1-D data-parallel mesh over all (or the given) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def build_sharded_sim_step(code: QCCode, cfg: SimConfig,
                           mesh: Mesh) -> Callable:
    """Returns step(key, sigma) -> dict of replicated int32 scalar counters.

    ``cfg.batch_per_device`` frames run on EACH device; the global batch is
    ``batch_per_device * mesh.size``.  Implemented with ``shard_map`` so the
    per-device body is explicit: fold the device index into the key (the
    equivalent of the reference's per-thread seed table, CSimulate.cpp:11-17)
    and ``psum`` the counters.
    """
    step = build_sim_step(code, cfg)
    axis = mesh.axis_names[0]

    def device_body(key: jax.Array, sigma: jax.Array) -> dict:
        key = jax.random.fold_in(key, jax.lax.axis_index(axis))
        stats = step(key, sigma)
        return jax.tree.map(lambda x: jax.lax.psum(x, axis), stats)

    shmap = jax.shard_map(
        device_body,
        mesh=mesh,
        in_specs=(P(), P()),
        out_specs=P(),
    )
    return jax.jit(shmap)


def build_sharded_sim_loop(code: QCCode, cfg: SimConfig, mesh: Mesh,
                           rounds: int) -> Callable:
    """Like build_sharded_sim_step but runs ``rounds`` Monte-Carlo rounds
    per call with on-device accumulation (one host sync + one psum per
    ``rounds`` batches).  loop(key, sigma, round0) -> replicated counters.
    """
    loop = build_sim_loop(code, cfg, rounds)
    axis = mesh.axis_names[0]

    def device_body(key: jax.Array, sigma: jax.Array,
                    round0: jax.Array) -> dict:
        key = jax.random.fold_in(key, jax.lax.axis_index(axis))
        stats = loop(key, sigma, round0)
        return jax.tree.map(lambda x: jax.lax.psum(x, axis), stats)

    shmap = jax.shard_map(
        device_body,
        mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=P(),
    )
    return jax.jit(shmap)


def replicate_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def batch_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(BATCH_AXIS))
