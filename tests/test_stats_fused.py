"""Iteration-histogram counter of the sim step."""

import numpy as np
import jax.numpy as jnp


def test_histogram_equals_bincount(rng):
    from faid.sim.pipeline import _histogram

    x = jnp.asarray(rng.integers(-2, 15, size=(257,)).astype(np.int32))
    want = jnp.bincount(jnp.clip(x, 0, 10), length=11)
    got = _histogram(x, 11)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
