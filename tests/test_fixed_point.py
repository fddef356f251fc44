"""Unit tests for the saturating fixed-point layer vs scalar semantics of
the reference intrinsics (CLDPC.h:23-96, CLDPC.cpp:4385-4770)."""

import numpy as np
import jax.numpy as jnp

from faid.ops import fixed_point as fp


def _adds_epi8_ref(a, b):
    return np.clip(a.astype(np.int32) + b, -128, 127)


def test_adds_subs(rng):
    a = rng.integers(-128, 128, 1000).astype(np.int32)
    b = rng.integers(-128, 128, 1000).astype(np.int32)
    assert (np.asarray(fp.adds8(jnp.asarray(a), jnp.asarray(b)))
            == _adds_epi8_ref(a, b)).all()
    assert (np.asarray(fp.subs8(jnp.asarray(a), jnp.asarray(b)))
            == np.clip(a.astype(np.int32) - b, -128, 127)).all()


def test_sign_epi8(rng):
    a = rng.integers(-100, 101, 1000)
    b = rng.integers(-3, 4, 1000)
    got = np.asarray(fp.sign_epi8(jnp.asarray(a), jnp.asarray(b)))
    exp = np.where(b < 0, -a, np.where(b == 0, 0, a))
    assert (got == exp).all()


def test_vn_saturation_window(rng):
    en = rng.integers(-31, 32, 1000)
    lmn = rng.integers(-7, 8, 1000)
    vc = np.asarray(fp.vn_sub_sat(jnp.asarray(en), jnp.asarray(lmn)))
    assert vc.min() >= fp.SAT_NEG_VAR
    msg = rng.integers(-7, 8, 1000)
    en2 = np.asarray(fp.vn_add_sat(jnp.asarray(vc), jnp.asarray(msg)))
    assert en2.min() >= fp.SAT_NEG_VAR and en2.max() <= fp.SAT_POS_VAR


def _quant_ref(x, scale, bits):
    """Scalar re-derivation of float2LimitChar_{bits}bit."""
    y = x * scale
    if bits == 1:
        t = np.trunc(y)
        return np.where(t > 0, 31, -31)
    lims = {6: (-31, 31), 5: (-16, 15), 4: (-7, 7), 3: (-4, 3), 2: (-2, 1)}
    lo, hi = lims[bits]
    if bits == 6:
        # cvtps_epi32 = round half to even
        q = np.round(y)
    else:
        q = np.trunc(y)
    return np.clip(np.clip(q, -128, 127), lo, hi)


def test_quantizers(rng):
    x = (rng.standard_normal(5000) * 1.2).astype(np.float32)
    for bits in (1, 2, 3, 4, 5, 6):
        got = np.asarray(fp.quantize_llr(jnp.asarray(x), 13.0, bits))
        exp = _quant_ref(x, np.float32(13.0), bits)
        assert (got == exp).all(), bits


def test_quantizer_round_half_even():
    # 6-bit uses round-half-to-even like cvtps_epi32: 0.5*scale edge cases.
    x = jnp.asarray([0.5 / 13, 1.5 / 13, -0.5 / 13], jnp.float32)
    got = np.asarray(fp.quantize_llr(x, 13.0, 6))
    # 0.5 -> 0 (even), 1.5 -> 2 (even), -0.5 -> 0
    assert got.tolist() == [0, 2, 0]
