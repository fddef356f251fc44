"""Native GF(2) library vs the numpy reference implementations."""

import numpy as np
import pytest

from faid.code import encoder as enc
from faid.code.toy import toy_code

native = pytest.importorskip("faid.utils.native")


@pytest.fixture(scope="module")
def lib_ok():
    try:
        native.get_lib()
    except Exception as e:  # no compiler in env
        pytest.skip(f"native build unavailable: {e}")


def test_solve_parity_matches_numpy(lib_ok):
    code = toy_code()
    h = code.h_dense()
    p_np = enc.solve_parity_projection(h, code.n_info)
    p_nat = native.gf2_solve_parity(h, code.n_info)
    np.testing.assert_array_equal(p_np, p_nat)


def test_solve_parity_singular_raises(lib_ok):
    h = np.zeros((4, 8), dtype=np.uint8)
    with pytest.raises(ValueError):
        native.gf2_solve_parity(h, 4)


def test_matmul_mod2(lib_ok, rng):
    a = rng.integers(0, 2, (17, 33)).astype(np.uint8)
    b = rng.integers(0, 2, (33, 71)).astype(np.uint8)
    np.testing.assert_array_equal(native.gf2_matmul_mod2(a, b),
                                  (a.astype(int) @ b.astype(int)) % 2)


def test_syndrome_weight(lib_ok, rng):
    code = toy_code()
    h = code.h_dense()
    c = rng.integers(0, 2, (5, code.n_var)).astype(np.uint8)
    np.testing.assert_array_equal(
        native.gf2_syndrome_weight(h, c),
        ((c.astype(int) @ h.T.astype(int)) % 2).sum(axis=1))


def test_full_code_parity_matches_cached(lib_ok, code):
    """Native solve on the real 50G-PON H equals the committed cache."""
    p_cached = enc.encoder_matrix(code)
    p_nat = native.gf2_solve_parity(code.h_dense(), code.n_info)
    np.testing.assert_array_equal(p_cached, p_nat)
