"""Forensic replay contract: for the same round key, build_debug_step
regenerates exactly the frames build_sim_step counted, so the runner's
error-frame dumps (MonteCarloRunner.collect_error_frames) show the
frames that failed in the sweep.  Both channel laws, fake and real
codewords, BPSK/QPSK, three decoder families and the 6-bit ingest."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from faid.code.toy import toy_code
from faid.config import DecodeMethod, SimConfig
from faid.sim.pipeline import build_debug_step, build_sim_step


@pytest.mark.parametrize("channel", ["xla", "fused"])
@pytest.mark.parametrize("fake,mod,method,quant", [
    (True, 2, DecodeMethod.FAID_DTBF, 4),
    (False, 2, DecodeMethod.FAID_DTBF, 4),
    (True, 1, DecodeMethod.FAID_DTBF, 4),
    (False, 1, DecodeMethod.FAID_DTBF, 4),
    (True, 2, DecodeMethod.OMS, 4),
    (True, 2, DecodeMethod.OMS_DTBF, 4),
    (False, 2, DecodeMethod.FAID_DTBF, 6),
])
def test_debug_step_replays_sim_step_counters(fake, mod, method, quant,
                                              channel):
    code = toy_code()
    cfg = SimConfig(decode_method=method, mod_type=mod, max_iteration=4,
                    batch_per_device=64, fake_encode=fake, quant_bits=quant,
                    channel_backend=channel, stop_mode="group", seed=7)
    key = jax.random.key(123)
    sigma = jnp.float32(cfg.sigma_at(1.0))    # toy-code waterfall
    got = jax.tree.map(np.asarray,
                       jax.jit(build_sim_step(code, cfg))(key, sigma))
    dbg = jax.tree.map(np.asarray,
                       jax.jit(build_debug_step(code, cfg))(key, sigma))

    err = dbg["err_bits"]
    assert got["test_frames"] == cfg.batch_per_device
    assert 0 < got["error_frames"] < cfg.batch_per_device
    assert got["error_bits"] == err.sum()
    assert got["error_frames"] == (err > 0).sum()
    assert got["lt3_frames"] == ((err > 0) & (err < 3)).sum()
    assert got["mp_iters"] == dbg["mp_iters"].sum()
    assert got["bf_rounds"] == dbg["bf_rounds"].sum()
    # The replayed frames are the transmitted ones: info bits differ
    # from the decode exactly where err_bits counts them.
    diff = dbg["hard"][:, :code.n_info] != dbg["cw"][:, :code.n_info].astype(bool)
    np.testing.assert_array_equal(diff.sum(axis=1), err)
    assert fake == (not dbg["cw"].any())
