"""Bit-exactness of the batched JAX decoders vs the scalar numpy golden
model (faid/golden/model.py) for all six reference decode methods, on
both adversarial random LLRs and realistic noisy-channel LLRs.

The golden model walks the flat edge list one CN at a time (the
reference's own structure); the JAX decoders use dense block rolls -
agreement validates the QC transformation and the fixed-point algebra
(SURVEY.md §4)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from faid.config import DecodeMethod, DecoderConfig
from faid.decoders.core import build_decoder
from faid.golden.model import decode_golden

# The method-0 rows deliberately run the reference sweep's shared 1/6
# factors to pin the degenerate (min*1)>>5 == 0 NMS datapath; the
# footgun warning is the tested behavior, not noise.
pytestmark = pytest.mark.filterwarnings("ignore:NMS normalization")

METHODS = list(DecodeMethod)


def small_cfg(method, max_iter=2, bf_iter=3):
    dcfg = DecoderConfig.for_method(method, max_iter=max_iter)
    if dcfg.bf.kind != "none":
        dcfg = dataclasses.replace(
            dcfg, bf=dataclasses.replace(dcfg.bf, max_iter=bf_iter))
    return dcfg


def noisy_zero_llrs(code, rng, batch, sigma=0.8, scale=13.0):
    """All-zero codeword over BPSK AWGN, 4-bit quantized (numpy)."""
    y = -1.0 + sigma * rng.standard_normal((batch, code.n_var))
    return np.clip(np.trunc(y * scale), -7, 7).astype(np.int8)


@pytest.mark.parametrize("method", METHODS)
def test_bit_exact_random_llrs(code, rng, method):
    """JAX vs the slow numpy oracle (1 frame per method; wide-coverage
    parity lives in test_native_golden.py against the fast C++ oracle)."""
    dcfg = small_cfg(method)
    dec = jax.jit(build_decoder(code, dcfg))
    batch = 1
    llr = rng.integers(-7, 8, size=(batch, code.n_var)).astype(np.int8)
    out = jax.tree.map(np.asarray, dec(jnp.asarray(llr)))
    for f in range(batch):
        g = decode_golden(llr[f], code, dcfg)
        np.testing.assert_array_equal(
            out["hard"][f].astype(np.uint8), g["hard"],
            err_msg=f"{method.name} frame {f}")


@pytest.mark.parametrize("method", [DecodeMethod.FAID_DTBF,
                                    DecodeMethod.OMS,
                                    DecodeMethod.NMS])
def test_bit_exact_noisy_channel(code, rng, method):
    dcfg = small_cfg(method, max_iter=3)
    dec = jax.jit(build_decoder(code, dcfg))
    llr = noisy_zero_llrs(code, rng, batch=1)
    out = jax.tree.map(np.asarray, dec(jnp.asarray(llr)))
    for f in range(llr.shape[0]):
        g = decode_golden(llr[f], code, dcfg)
        np.testing.assert_array_equal(out["hard"][f].astype(np.uint8),
                                      g["hard"])
        assert out["mp_iters"][f] == g["mp_iters"]
        assert out["bf_rounds"][f] == g["bf_rounds"]


def test_clean_llrs_decode_instantly(code):
    """All-zero codeword with strong correct LLRs: early stop at iter 0,
    zero BF rounds, all-zero output."""
    dcfg = DecoderConfig.for_method(DecodeMethod.FAID_DTBF)
    dec = jax.jit(build_decoder(code, dcfg))
    llr = jnp.full((2, code.n_var), -7, jnp.int8)
    out = jax.tree.map(np.asarray, dec(llr))
    assert not out["hard"].any()
    assert (out["mp_iters"] == 0).all()
    assert (out["bf_rounds"] == 0).all()


def test_high_snr_end_to_end_corrects_errors(code, rng):
    """Light noise on the all-zero codeword must decode to all zeros."""
    dcfg = DecoderConfig.for_method(DecodeMethod.FAID_DTBF)
    dec = jax.jit(build_decoder(code, dcfg))
    llr = noisy_zero_llrs(code, rng, batch=4, sigma=0.45)
    out = jax.tree.map(np.asarray, dec(jnp.asarray(llr)))
    assert not out["hard"].any()


def test_nms_has_no_early_stop(code):
    """Reference NMS (Decode) runs all iterations unconditionally
    (CLDPC.cpp:276)."""
    dcfg = DecoderConfig.for_method(DecodeMethod.NMS, max_iter=4)
    dec = jax.jit(build_decoder(code, dcfg))
    llr = jnp.full((1, code.n_var), -7, jnp.int8)
    out = jax.tree.map(np.asarray, dec(llr))
    assert (out["mp_iters"] == 4).all()


@pytest.mark.parametrize("family", ["faid32", "faid2"])
def test_bit_exact_other_lut_families(code, rng, family):
    """FAID32/FAID2 LUT families (reference #define alternatives)."""
    from faid.config import FaidLutFamily

    dcfg = DecoderConfig.for_method(DecodeMethod.FAID_DTBF, max_iter=2,
                                    lut_family=FaidLutFamily(family))
    dcfg = dataclasses.replace(
        dcfg, bf=dataclasses.replace(dcfg.bf, max_iter=2))
    dec = jax.jit(build_decoder(code, dcfg))
    llr = rng.integers(-7, 8, size=(1, code.n_var)).astype(np.int8)
    out = jax.tree.map(np.asarray, dec(jnp.asarray(llr)))
    g = decode_golden(llr[0], code, dcfg)
    np.testing.assert_array_equal(out["hard"][0].astype(np.uint8), g["hard"])
