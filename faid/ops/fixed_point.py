"""Bit-exact fixed-point primitives used by all decoders.

The reference computes in saturating int8 SIMD (``adds/subs_epi8``,
``packs_epi16`` etc., reference CLDPC.h:23-96).  Here we keep the tensors
in int8 for bandwidth but do the arithmetic in widened integers and clip,
which reproduces the saturating semantics exactly:

  adds_epi8(a,b)  == clip(a+b, -128, 127)
  subs_epi8(a,b)  == clip(a-b, -128, 127)
  packs_epi16(x)  == clip(x,   -128, 127)
  sign_epi8(a,b)  == where(b<0, -a, where(b==0, 0, a))

Quantizers reproduce CLDPC.cpp:4385-4770: 6-bit rounds to nearest-even
(cvtps_epi32), 4/5/3/2-bit truncate toward zero (cvttps_epi32), then
saturate to int8 and clamp to the per-width limits.
"""

from __future__ import annotations

import jax.numpy as jnp

INT8_MIN, INT8_MAX = -128, 127

# Saturation limits from NB_BITS_VARIABLES=6 / NB_BITS_MESSAGES=4
# (reference Constants_SSE.h:20-25).
SAT_POS_VAR, SAT_NEG_VAR = 31, -31
SAT_POS_MSG, SAT_NEG_MSG = 7, -7


def sat8(x: jnp.ndarray) -> jnp.ndarray:
    """Saturate a widened integer tensor to int8 range (stays widened)."""
    return jnp.clip(x, INT8_MIN, INT8_MAX)


def adds8(a, b):
    return sat8(a.astype(jnp.int32) + b.astype(jnp.int32))


def subs8(a, b):
    return sat8(a.astype(jnp.int32) - b.astype(jnp.int32))


def sign_epi8(a, b):
    """_mm256_sign_epi8: b<0 -> -a; b==0 -> 0; b>0 -> a."""
    return jnp.where(b < 0, -a, jnp.where(b == 0, jnp.zeros_like(a), a))


def vn_sub_sat(en, lmn):
    """VECTOR_SUB_AND_SATURATE_VAR_8bits: max(subs_epi8(en, lmn), SAT_NEG_VAR)."""
    return jnp.maximum(subs8(en, lmn), SAT_NEG_VAR)


def vn_add_sat(contr, msg):
    """VECTOR_ADD_AND_SATURATE_VAR_8bits then min with SAT_POS_VAR."""
    return jnp.minimum(jnp.maximum(adds8(contr, msg), SAT_NEG_VAR), SAT_POS_VAR)


_QUANT_LIMITS = {
    6: (-31, 31),
    5: (-16, 15),
    4: (-7, 7),
    3: (-4, 3),
    2: (-2, 1),
}


def quantize_llr(x: jnp.ndarray, scale: float, bits: int) -> jnp.ndarray:
    """float LLR -> int8 fixed point, reproducing float2LimitChar_{bits}bit.

    6-bit: round-to-nearest-even; 5..2-bit: truncate toward zero; 1-bit:
    sign slicing to +-31.  All include the int16->int8 pack saturation
    before the final clamp (irrelevant in practice but kept for exactness).
    """
    y = x * jnp.float32(scale)
    if bits == 1:
        t = jnp.trunc(y)
        return jnp.where(t > 0, jnp.int8(31), jnp.int8(-31))
    lo, hi = _QUANT_LIMITS[bits]
    if bits == 6:
        q = jnp.round(y)  # jnp.round = half-to-even, matching cvtps_epi32
    else:
        q = jnp.trunc(y)  # cvttps_epi32
    q = jnp.clip(q, INT8_MIN, INT8_MAX)  # packs_epi16 saturation
    return jnp.clip(q, lo, hi).astype(jnp.int8)
