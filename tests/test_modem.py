"""Modem tests: Gray-map mod/demod round trip, interleaver inversion,
demap sign correctness at high SNR (reference CModulate.cpp)."""

import numpy as np
import jax.numpy as jnp

from faid.ops import modem


def test_interleave_roundtrip(rng):
    for depth in (1, 2, 4, 8):
        bits = jnp.asarray(rng.integers(0, 2, size=(3, 64)).astype(np.int8))
        out = modem.deinterleave(modem.interleave(bits, depth), depth)
        assert (np.asarray(out) == np.asarray(bits)).all()


def test_interleave_semantics():
    # out[j*D + i] = in[(L/D)*i + j] (reference CModulate.cpp:138-149).
    length, depth = 12, 3
    x = jnp.arange(length)[None, :]
    y = np.asarray(modem.interleave(x, depth))[0]
    for i in range(depth):
        for j in range(length // depth):
            assert y[j * depth + i] == (length // depth) * i + j


def test_bpsk():
    bits = jnp.asarray([[0, 1, 1, 0]], jnp.int8)
    sym = np.asarray(modem.modulate_bpsk(bits))
    assert sym.tolist() == [[-1.0, 1.0, 1.0, -1.0]]


def _roundtrip(mod_type, rng):
    nsym = 1024
    bits = jnp.asarray(
        rng.integers(0, 2, size=(4, nsym * mod_type)).astype(np.int8))
    sym = modem.modulate_qam(bits, mod_type)
    # unit average energy (Gray tables are normalized)
    power = float(np.mean(np.asarray(sym) ** 2) * 2)
    assert abs(power - 1.0) < 0.05
    llr = modem.demodulate_qam(sym, mod_type)
    hard = (np.asarray(llr) > 0).astype(np.int8)
    assert (hard == np.asarray(bits)).all()


def test_qam_roundtrip_noiseless(rng):
    for mod_type in (2, 4, 6, 8):
        _roundtrip(mod_type, rng)


def test_qpsk_amplitudes():
    bits = jnp.asarray([[0, 0, 1, 1, 0, 1]], jnp.int8)
    sym = np.asarray(modem.modulate_qam(bits, 2))  # [1, 3, 2]
    a = 0.707107
    np.testing.assert_allclose(
        sym[0], [[-a, -a], [a, a], [-a, a]], rtol=1e-5)


def test_demod_fold_16qam():
    # b1 (LSB) LLR = |I| - 0.6324555: sign must flip at the fold point.
    sym = jnp.asarray([[[0.3, 0.3]], [[0.95, 0.95]]], jnp.float32)
    llr = np.asarray(modem.demodulate_qam(sym, 4))
    assert llr[0, 2] < 0 < llr[1, 2]
