"""The sharded Monte-Carlo loop on four devices (virtual CPU devices
here) equals, counter for counter, the sum of four one-device loops run
with the device index folded into the key - the contract that makes a
multi-device sweep and its resume exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from faid.code.toy import toy_code
from faid.config import DecodeMethod, SimConfig
from faid.parallel import mesh as mesh_mod
from faid.sim.pipeline import build_sim_loop


@pytest.mark.parametrize("encode", ["fake", "random"])
@pytest.mark.parametrize("channel", ["xla", "fused"])
def test_four_device_loop_equals_sum_of_single_device_loops(channel, encode):
    code = toy_code()
    cfg = SimConfig(decode_method=DecodeMethod.FAID_DTBF, max_iteration=4,
                    mod_type=2, batch_per_device=32, seed=5,
                    fake_encode=encode == "fake", channel_backend=channel,
                    stop_mode="group")
    mesh = mesh_mod.make_mesh(jax.devices()[:4])
    rounds = 3
    key = jax.random.key(cfg.seed)
    sigma = jnp.float32(cfg.sigma_at(1.5))
    round0 = jnp.int32(6)

    sharded = mesh_mod.build_sharded_sim_loop(code, cfg, mesh, rounds)
    got = jax.device_get(sharded(key, sigma, round0))

    one = jax.jit(build_sim_loop(code, cfg, rounds))
    want = None
    for d in range(4):
        out = jax.device_get(one(jax.random.fold_in(key, d), sigma, round0))
        want = out if want is None else jax.tree.map(np.add, want, out)

    assert int(got["test_frames"]) == 4 * rounds * cfg.batch_per_device
    assert int(got["error_frames"]) > 0
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)
