"""QC-LDPC code object for the 50G-PON code (and any code in the same form).

Replaces the reference's flat ``PosNoeudsVariable`` edge list + per-edge
pointer table (reference CLDPC.cpp:4813-4816) with the quasi-cyclic block
form: ``block_cols[r, e]`` / ``shifts[r, e]`` describe entry ``e`` of
block-row ``r`` as a Z x Z cyclically-shifted identity.  CN ``i`` of
block-row ``r`` connects to VN ``block_cols[r,e]*Z + (shifts[r,e] + i) % Z``.

The decoder state is laid out ``[batch, n_blocks, Z]`` so each block
entry is a dense roll, never a gather.
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path

import numpy as np

_DATA = Path(__file__).parent / "data"


@dataclasses.dataclass(frozen=True)
class QCCode:
    """Static description of a QC-LDPC code. Hashable / jit-static."""

    name: str
    z: int                      # circulant size (256)
    n_var: int                  # codeword length N (17664)
    n_chk: int                  # number of checks M (3072)
    block_cols: tuple           # tuple[tuple[int]] per block-row, padded -1
    shifts: tuple               # same shape as block_cols
    degrees: tuple              # CN degree per block-row
    vn_weight_key: str = "50gpon"   # lookup key for cached numpy arrays
    # Channel LLRs of the last `puncture_tail` VNs are zeroed before
    # decoding (the reference's de-facto punctured tail, CLDPC.cpp:270-272;
    # 384 for 50G-PON, making the effective rate 14592/17280).
    puncture_tail: int = 0

    # -- derived sizes ------------------------------------------------------
    @property
    def n_info(self) -> int:
        return self.n_var - self.n_chk

    @property
    def n_block_cols(self) -> int:
        return self.n_var // self.z

    @property
    def n_block_rows(self) -> int:
        return self.n_chk // self.z

    @property
    def max_deg(self) -> int:
        return max(self.degrees)

    @property
    def n_edges(self) -> int:
        return self.z * sum(self.degrees)

    # -- numpy views (cached, not part of the hashable identity) ------------
    @functools.cached_property
    def block_cols_np(self) -> np.ndarray:
        return np.asarray(self.block_cols, dtype=np.int32)

    @functools.cached_property
    def shifts_np(self) -> np.ndarray:
        return np.asarray(self.shifts, dtype=np.int32)

    @functools.cached_property
    def degrees_np(self) -> np.ndarray:
        return np.asarray(self.degrees, dtype=np.int32)

    @functools.cached_property
    def valid_np(self) -> np.ndarray:
        """[n_block_rows, max_deg] bool - True where entry exists."""
        return self.block_cols_np >= 0

    @functools.cached_property
    def vn_weight_np(self) -> np.ndarray:
        """Column weight per VN, [n_var] int32 (reference CLDPC.cpp:4998)."""
        w = np.zeros(self.n_var, dtype=np.int32)
        for r in range(self.n_block_rows):
            for e in range(self.degrees[r]):
                c, s = self.block_cols[r][e], self.shifts[r][e]
                w[c * self.z : (c + 1) * self.z] += 1
        return w

    @functools.cached_property
    def vn_weight_blocks_np(self) -> np.ndarray:
        """[n_block_cols, z] column weights in block layout."""
        return self.vn_weight_np.reshape(self.n_block_cols, self.z)

    @functools.cached_property
    def edge_list_np(self) -> np.ndarray:
        """Flat row-major CN->VN edge list (reference PosNoeudsVariable
        order: block-rows in order, rows within a block-row in order,
        entries within a row in stored column order)."""
        out = []
        for r in range(self.n_block_rows):
            cols = self.block_cols_np[r, : self.degrees[r]]
            shf = self.shifts_np[r, : self.degrees[r]]
            for i in range(self.z):
                out.append(cols * self.z + (shf + i) % self.z)
        return np.concatenate(out).astype(np.int32)

    def h_dense(self) -> np.ndarray:
        """Dense H as uint8 [n_chk, n_var] (tests / encoder precompute)."""
        h = np.zeros((self.n_chk, self.n_var), dtype=np.uint8)
        rows = np.repeat(np.arange(self.n_chk), [self.degrees[r] for r in
                                                  np.arange(self.n_chk) // self.z])
        h[rows, self.edge_list_np] = 1
        return h


def load_code(name: str = "50gpon") -> QCCode:
    d = np.load(_DATA / f"{name}.npz")
    return QCCode(
        name=name,
        z=int(d["z"]),
        n_var=int(d["n_var"]),
        n_chk=int(d["n_chk"]),
        block_cols=tuple(tuple(int(x) for x in row) for row in d["block_cols"]),
        shifts=tuple(tuple(int(x) for x in row) for row in d["shifts"]),
        degrees=tuple(int(x) for x in d["degrees"]),
        puncture_tail=384 if name == "50gpon" else 0,
    )
