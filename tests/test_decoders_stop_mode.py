"""Early-stop granularity of the batched JAX decoder on the full code:
stop_mode='group' (the reference's 32-frame SIMD-word rule) against
itself and against stop_mode='frame'.  Bit-exactness against the golden
model is tests/test_decoders.py; group mode against the golden model on
replicated frames is tests/test_decoder_golden_toy.py."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from faid.config import DecodeMethod
from faid.decoders.core import build_decoder

from test_decoders import noisy_zero_llrs, small_cfg


def test_group_stop_mode_is_groupwise(code, rng):
    """stop_mode='group' with batch=64 must equal two independent 32-frame
    group decodes (the reference dispatches one 32-frame SIMD word per
    Decode call, CLDPC.h:21): groups must not influence each other."""
    dcfg = small_cfg(DecodeMethod.FAID_DTBF, max_iter=3, bf_iter=3)
    dcfg = dataclasses.replace(dcfg, stop_mode="group")
    dec = jax.jit(build_decoder(code, dcfg))
    llr = noisy_zero_llrs(code, rng, 64, sigma=0.55)
    full = np.asarray(dec(jnp.asarray(llr))["hard"])
    lo = np.asarray(dec(jnp.asarray(llr[:32]))["hard"])
    hi = np.asarray(dec(jnp.asarray(llr[32:]))["hard"])
    np.testing.assert_array_equal(full, np.concatenate([lo, hi]))


def test_group_stop_mode_iters_uniform_per_group(code, rng):
    """In group mode every frame of a 32-frame group is updated while any
    group-mate is dirty, so mp_iters (like bf_rounds) must be recorded at
    group granularity: identical within each group."""
    dcfg = small_cfg(DecodeMethod.FAID_DTBF, max_iter=4, bf_iter=3)
    dcfg = dataclasses.replace(dcfg, stop_mode="group")
    dec = jax.jit(build_decoder(code, dcfg))
    out = jax.tree.map(np.asarray,
                       dec(jnp.asarray(noisy_zero_llrs(code, rng, 64,
                                                       sigma=0.55))))
    for g in range(2):
        grp = out["mp_iters"][32 * g:32 * (g + 1)]
        assert (grp == grp[0]).all(), grp


def test_group_vs_frame_stop_modes_agree_when_converged(code, rng):
    """At high SNR every frame converges on its own, so the early-stop
    granularity must not change the output."""
    dcfg = small_cfg(DecodeMethod.OMS, max_iter=4)
    llr = noisy_zero_llrs(code, rng, 32, sigma=0.35)
    out_f = np.asarray(jax.jit(build_decoder(code, dcfg))(
        jnp.asarray(llr))["hard"])
    out_g = np.asarray(jax.jit(build_decoder(
        code, dataclasses.replace(dcfg, stop_mode="group")))(
        jnp.asarray(llr))["hard"])
    np.testing.assert_array_equal(out_f, out_g)
