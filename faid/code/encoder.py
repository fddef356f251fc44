"""GF(2) systematic encoder for QC-LDPC codes.

The reference encodes with a sparse generator table ``GenMatrix`` whose data
blobs are missing from the checkout (reference Constants_SSE.h:3106,
README.md:9), so we reconstruct the encoder from H directly: with the
codeword split c = [u | p] (info, parity), H c^T = 0 gives
``p = (H_p^{-1} H_i) u`` over GF(2).  The dense projection matrix
``P = H_p^{-1} H_i``  (n_chk x n_info) is computed once with bit-packed
Gaussian elimination and cached; encoding is then a single int8 x int8 ->
int32 matmul followed by a mod-2 (reference Encode() is an XOR-gather
loop, CLDPC.cpp:88-94 - a scatter-bound pattern we deliberately avoid).
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from .qc_matrix import QCCode

_CACHE = Path(__file__).parent / "data"


def _pack_bits(a: np.ndarray) -> np.ndarray:
    """[rows, cols] uint8 {0,1} -> [rows, ceil(cols/64)] uint64 bit-pack."""
    rows, cols = a.shape
    pad = (-cols) % 64
    if pad:
        a = np.pad(a, ((0, 0), (0, pad)))
    bits = a.reshape(rows, -1, 64).astype(np.uint64)
    weights = (np.uint64(1) << np.arange(64, dtype=np.uint64))[None, None, :]
    return (bits * weights).sum(axis=2, dtype=np.uint64)


def _unpack_bits(p: np.ndarray, cols: int) -> np.ndarray:
    rows = p.shape[0]
    bits = (p[:, :, None] >> np.arange(64, dtype=np.uint64)[None, None, :]) & np.uint64(1)
    return bits.reshape(rows, -1)[:, :cols].astype(np.uint8)


def solve_parity_projection(h: np.ndarray, n_info: int) -> np.ndarray:
    """Return P with parity = (P @ u) % 2, via elimination on [H_p | H_i].

    Raises if the parity submatrix H_p is singular over GF(2).
    """
    n_chk = h.shape[0]
    hp = h[:, n_info:]
    hi = h[:, :n_info]
    aug = _pack_bits(np.concatenate([hp, hi], axis=1))
    ncols_aug = n_chk + n_info

    # Forward elimination + back substitution to reduced row echelon form.
    for col in range(n_chk):
        word, bit = divmod(col, 64)
        mask = np.uint64(1) << np.uint64(bit)
        col_bits = (aug[:, word] & mask) != 0
        pivot_candidates = np.nonzero(col_bits[col:])[0]
        if pivot_candidates.size == 0:
            raise ValueError(f"H_p singular at column {col}")
        piv = col + int(pivot_candidates[0])
        if piv != col:
            aug[[col, piv]] = aug[[piv, col]]
            col_bits[[col, piv]] = col_bits[[piv, col]]
        elim = col_bits.copy()
        elim[col] = False
        rows = np.nonzero(elim)[0]
        if rows.size:
            aug[rows] ^= aug[col]
    # Now left block is identity; right block rows are P.
    full = _unpack_bits(aug, ncols_aug)
    return full[:, n_chk:]


def encoder_matrix(code: QCCode, cache: bool = True) -> np.ndarray:
    """[n_chk, n_info] uint8 parity projection matrix, cached on disk."""
    if code.name.startswith("toy_"):
        cache = False  # synthetic test codes are cheap to recompute
    path = _CACHE / f"{code.name}_encoder.npz"
    if cache and path.exists():
        return np.load(path)["p"]
    # Prefer the native bit-packed solver when available (~100x numpy).
    h = code.h_dense()
    try:
        from faid.utils import native  # noqa: PLC0415

        p = native.gf2_solve_parity(h, code.n_info)
    except Exception:
        p = solve_parity_projection(h, code.n_info)
    if cache:
        np.savez_compressed(path, p=p)
    return p


def make_encode_fn(code: QCCode):
    """Returns encode(u_bits[batch, n_info] int8) -> c[batch, n_var] int8.

    The mod-2 matmul accumulates in int32; exact because row sums are
    bounded by n_info << 2^31.
    """
    p_t = jnp.asarray(encoder_matrix(code).T.astype(np.int8))  # [n_info, n_chk]

    def encode(u: jax.Array) -> jax.Array:
        acc = jax.lax.dot_general(
            u.astype(jnp.int8), p_t,
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        parity = (acc & 1).astype(jnp.int8)
        return jnp.concatenate([u.astype(jnp.int8), parity], axis=1)

    return encode


def syndrome_weight_np(code: QCCode, c: np.ndarray) -> np.ndarray:
    """Number of unsatisfied checks per frame (numpy, for tests)."""
    h = code.h_dense()
    return ((c @ h.T) % 2).sum(axis=1)
