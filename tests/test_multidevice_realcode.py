"""Multi-device execution of the REAL 50G-PON code under shard_map on
the 8-virtual-device CPU mesh (the toy-code mesh tests live in
tests/test_pipeline.py and tests/test_mesh_equivalence.py)."""

import jax
import jax.numpy as jnp
import numpy as np

from faid.config import DecodeMethod, SimConfig
from faid.parallel import mesh as mesh_mod
from faid.sim.pipeline import build_sim_step


def test_sharded_real_code_matches_manual_reduction(code):
    """The full 50G-PON code through the sharded pipeline: the shard_map
    + psum result must equal the sum of 8 single-device steps run with
    the same device-folded keys (bit-exact, not statistical)."""
    mesh = mesh_mod.make_mesh()
    assert mesh.size == 8
    cfg = SimConfig(decode_method=DecodeMethod.OMS, max_iteration=2,
                    mod_type=2, batch_per_device=4, seed=7,
                    fake_encode=True)
    sigma = jnp.float32(cfg.sigma_at(3.6))
    key = jax.random.key(cfg.seed)

    sharded = mesh_mod.build_sharded_sim_step(code, cfg, mesh)
    got = jax.device_get(sharded(key, sigma))

    step = jax.jit(build_sim_step(code, cfg))
    want = None
    for d in range(mesh.size):
        out = jax.device_get(step(jax.random.fold_in(key, d), sigma))
        want = out if want is None else jax.tree.map(np.add, want, out)

    assert int(got["test_frames"]) == 4 * 8
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)
