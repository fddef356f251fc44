"""AWGN channel.

The reference has two RNG paths (MKL MT2203 vsRngGaussian for BPSK,
reference CChannel.cpp:102-109; a Wichmann-Hill + Box-Muller scalar path
for complex QAM, :71-97).  We deliberately do not reproduce those streams:
the statistical contract (N(0, sigma^2) i.i.d. noise with the same sigma
and quantizer) is what fixes the FER curve.  Our noise comes from
``jax.random.normal`` with splittable keys, which makes every frame's
noise reproducible from (seed, round, frame) - the equivalent
of the reference's per-thread seed tables (CSimulate.cpp:11-17) and
Temp.txt seed checkpointing (main.cpp:200-207).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def awgn_real(key: jax.Array, signal: jnp.ndarray, sigma) -> jnp.ndarray:
    """y = x + N(0, sigma^2); signal [batch, n] (BPSK path,
    reference CChannel.cpp:102-109)."""
    noise = jax.random.normal(key, signal.shape, dtype=jnp.float32)
    return signal + jnp.float32(sigma) * noise

def awgn_complex(key: jax.Array, sym: jnp.ndarray, sigma_component) -> jnp.ndarray:
    """Complex AWGN: independent noise per I and Q rail with the given
    per-component sigma (the caller passes sigma/sqrt(2), matching
    reference CSimulate.cpp:126).  sym [batch, nsym, 2]."""
    noise = jax.random.normal(key, sym.shape, dtype=jnp.float32)
    return sym + jnp.float32(sigma_component) * noise
