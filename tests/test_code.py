"""Code-structure golden tests (SURVEY.md §4: edge count 70400, degree
histogram 256/256/2560, parity of H blocks vs the reference's
PosNoeudsVariable table), plus the external encoder anchor: the real
50G-PON codeword the reference keeps commented in Codeword.h:5-460."""

from pathlib import Path

import numpy as np
import pytest

from faid.code import encoder as enc

_REF_CODEWORD = Path(__file__).parent.parent / "faid/code/data/50gpon_codeword.npz"


def _reference_codeword() -> np.ndarray:
    return np.load(_REF_CODEWORD)["codeword"]


def test_sizes(code):
    assert code.n_var == 17664
    assert code.n_chk == 3072
    assert code.z == 256
    assert code.n_info == 14592
    assert code.n_edges == 70400
    assert code.n_block_rows == 12
    assert code.n_block_cols == 69


def test_degree_histogram(code):
    # Reference: 256 rows deg-23, 256 rows deg-22, 2560 rows deg-23
    # (Constants_SSE.h:14-19) == block-rows [23, 22, 23 x 10].
    degs = list(code.degrees)
    assert degs.count(23) == 11
    assert degs.count(22) == 1
    assert sum(d * code.z for d in degs) == 70400


def test_column_weights(code):
    w = code.vn_weight_np
    assert w.sum() == code.n_edges
    assert w.min() >= 1
    # The DTBF flip rule targets weight-3 VNs; the code must have them.
    assert (w == 3).sum() > 0


def test_edge_list_matches_dense_h(code):
    h = code.h_dense()
    assert h.sum() == code.n_edges
    # every check row's degree matches its block-row degree
    row_deg = h.sum(axis=1)
    for r in range(code.n_block_rows):
        assert (row_deg[r * code.z:(r + 1) * code.z] == code.degrees[r]).all()


def test_blocks_are_shifted_identities(code):
    h = code.h_dense()
    z = code.z
    for r in range(code.n_block_rows):
        for e in range(code.degrees[r]):
            c = code.block_cols[r][e]
            s = code.shifts[r][e]
            blk = h[r * z:(r + 1) * z, c * z:(c + 1) * z]
            expect = np.roll(np.eye(z, dtype=np.uint8), -s, axis=1) if False \
                else None
            # CN i connects VN (s + i) % z within the block.
            rows = np.arange(z)
            assert (blk[rows, (s + rows) % z] == 1).all()


def test_encoder_roundtrip(code, rng):
    """encode -> H c^T == 0 for random messages (SURVEY.md §4)."""
    import jax.numpy as jnp
    encode = enc.make_encode_fn(code)
    u = rng.integers(0, 2, size=(4, code.n_info)).astype(np.int8)
    c = np.asarray(encode(jnp.asarray(u)))
    assert c.shape == (4, code.n_var)
    assert (c[:, :code.n_info] == u).all()          # systematic
    assert (enc.syndrome_weight_np(code, c) == 0).all()


def test_reference_codeword_fixture_provenance():
    """The committed fixture re-parses byte-for-byte from the reference's
    commented '50G PON NS NP' vector (reference Codeword.h:5-460)."""
    ref = Path("/root/reference/Codeword.h")
    if not ref.exists():
        pytest.skip("reference checkout not present")
    from faid.code.extract import parse_reference_codeword
    np.testing.assert_array_equal(parse_reference_codeword(ref),
                                  _reference_codeword())


def test_reference_codeword_anchors_h_extraction(code):
    """H . c = 0 for the reference authors' own non-zero codeword: an
    external known-answer check on the extracted H (it was generated by
    their original GenMatrix, not by anything in this repo)."""
    c = _reference_codeword()
    assert c.shape == (code.n_var,)
    assert 0 < c.sum() < code.n_var  # genuinely non-trivial
    assert enc.syndrome_weight_np(code, c[None, :]) == 0


def test_reference_codeword_anchors_encoder(code):
    """encode(c[:K]) == c: external known-answer anchor for the
    reconstructed GF(2) parity projection, on both the numpy P matrix and
    the MXU matmul path (reference Encode(), CLDPC.cpp:68-155)."""
    import jax.numpy as jnp
    c = _reference_codeword()
    u = c[:code.n_info]
    # numpy projection
    p = enc.encoder_matrix(code)
    np.testing.assert_array_equal((p @ u) % 2, c[code.n_info:])
    # MXU path
    out = np.asarray(enc.make_encode_fn(code)(jnp.asarray(u[None].astype(np.int8))))
    np.testing.assert_array_equal(out[0], c)


def test_encoder_zero_message(code):
    import jax.numpy as jnp
    encode = enc.make_encode_fn(code)
    c = np.asarray(encode(jnp.zeros((1, code.n_info), jnp.int8)))
    assert (c == 0).all()
