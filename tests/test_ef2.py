"""EF_ELIMINATION=2 (one-shot weight-3 erasure) parity: golden vs JAX.

This mode is reachable only via custom config (no reference decode method
compiles it in by default), and its erase flags reset at the top of every
iteration (reference CDecoder_FAID.cpp:624-628) - the regression this
test pins down."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from faid.code.toy import toy_code
from faid.config import DecodeMethod, DecoderConfig
from faid.decoders.core import build_decoder
from faid.golden.model import decode_golden


def ef2_cfg():
    base = DecoderConfig.for_method(DecodeMethod.FAID_DTBF, max_iter=4)
    return dataclasses.replace(
        base, ef_elimination=2, floor_err_count=100000,
        floor_iter_thresh=4,
        bf=dataclasses.replace(base.bf, max_iter=2))


def test_ef2_bit_exact_vs_golden(rng):
    code = toy_code()
    dcfg = ef2_cfg()
    dec = jax.jit(build_decoder(code, dcfg))
    batch = 32
    llr = rng.integers(-7, 8, size=(batch, code.n_var)).astype(np.int8)
    out = jax.tree.map(np.asarray, dec(jnp.asarray(llr)))
    for f in range(batch):
        g = decode_golden(llr[f], code, dcfg)
        np.testing.assert_array_equal(out["hard"][f].astype(np.uint8),
                                      g["hard"], err_msg=f"frame {f}")
        assert out["mp_iters"][f] == g["mp_iters"]


def test_ef2_changes_behavior(rng):
    """The erasure path must actually fire for this test setup to mean
    anything: EF2 output differs from EF0 on at least one noisy frame."""
    code = toy_code()
    d2 = ef2_cfg()
    d0 = dataclasses.replace(d2, ef_elimination=0)
    dec2 = jax.jit(build_decoder(code, d2))
    dec0 = jax.jit(build_decoder(code, d0))
    llr = rng.integers(-7, 8, size=(64, code.n_var)).astype(np.int8)
    h2 = np.asarray(dec2(jnp.asarray(llr))["hard"])
    h0 = np.asarray(dec0(jnp.asarray(llr))["hard"])
    assert (h2 != h0).any()
