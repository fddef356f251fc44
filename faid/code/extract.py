"""Extract the 50G-PON QC-LDPC structure from the reference constants header.

The reference stores the parity-check matrix H as a flat, row-major list of
variable-node indices per check node (``PosNoeudsVariable``, 70400 entries;
see reference Constants/50GPON-dc-original/Constants_SSE.h:29-3103).  That
representation forces a pointer-chasing edge walk.  The batched decoder
wants the quasi-cyclic *block* form instead: H is a 12 x 69 grid of Z x Z blocks
(Z = 256) where every non-zero block is a cyclically shifted identity.
CN ``i`` of block-row ``r`` then connects, for each block entry ``(c, s)``,
to VN ``c*Z + (s + i) % Z`` - so a whole block-row of 256 CN updates is a
dense ``jnp.roll`` per entry rather than a gather.

This script parses the numeric matrix data (pure data, not code), verifies
the circulant structure exhaustively, and emits ``data/50gpon.npz``.

Run:  python -m faid.code.extract /root/reference
"""

from __future__ import annotations

import re
import sys
from pathlib import Path

import numpy as np

# Code geometry, cf. reference Constants_SSE.h:4-25.
N_VAR = 17664
N_CHK = 3072
N_EDGE = 70400
Z = 256
# Three CN-degree groups: (degree, #rows), Constants_SSE.h:14-19.
DEGREE_GROUPS = [(23, 256), (22, 256), (23, 2560)]


def parse_pos_noeuds(constants_path: Path) -> np.ndarray:
    """Parse the flat PosNoeudsVariable edge list out of the header text."""
    text = constants_path.read_text()
    start = text.index("PosNoeudsVariable[ ]={")
    end = text.index("};", start)
    body = text[start:end]
    # Strip /* ... */ row-comments, then collect integers.
    body = re.sub(r"/\*.*?\*/", " ", body)
    body = body.split("{", 1)[1]
    vals = np.array([int(tok) for tok in re.findall(r"\d+", body)], dtype=np.int32)
    if vals.size != N_EDGE:
        raise ValueError(f"expected {N_EDGE} edges, parsed {vals.size}")
    return vals


def parse_reference_codeword(codeword_path: Path) -> np.ndarray:
    """Parse the real 50G-PON codeword the reference keeps commented out.

    ``Codeword.h`` ships ``CodeWord_sym`` as all zeros but retains a genuine
    non-zero codeword ("50G PON NS NP") in a comment block (reference
    Codeword.h:5-460).  That vector is the one external known-answer fixture
    for the encoder datapath: it was produced by the reference authors'
    *original* generator matrix (the ``GenMatrix`` blobs absent from the
    checkout, Constants_SSE.h:3106), so H.c = 0 under our extracted H and
    encode(c[:K]) == c anchor both the H extraction and the reconstructed
    GF(2) parity projection against data we did not derive ourselves.
    """
    text = codeword_path.read_text()
    m = re.search(r"//\s*50G PON NS NP\s*\n(.*?)\};", text, re.S)
    if m is None:
        raise ValueError("commented '50G PON NS NP' codeword not found")
    bits = np.array(
        [int(tok) for tok in re.findall(r"[01]", m.group(1).replace("//", " "))],
        dtype=np.uint8,
    )
    if bits.size != N_VAR:
        raise ValueError(f"expected {N_VAR} codeword bits, parsed {bits.size}")
    return bits


def rows_from_flat(flat: np.ndarray) -> list[np.ndarray]:
    """Split the flat edge list into per-CN rows using the degree groups."""
    rows = []
    off = 0
    for deg, count in DEGREE_GROUPS:
        for _ in range(count):
            rows.append(flat[off : off + deg])
            off += deg
    assert off == N_EDGE
    return rows


def extract_block_structure(rows: list[np.ndarray]):
    """Recover (block_col, shift) per block-row; verify every block is a
    shifted identity and that block-columns within a block-row are distinct."""
    n_block_rows = N_CHK // Z
    block_cols, shifts, degrees = [], [], []
    for r in range(n_block_rows):
        row0 = rows[r * Z]
        deg = len(row0)
        cols0 = row0 // Z
        offs0 = row0 % Z
        if len(set(cols0.tolist())) != deg:
            raise ValueError(f"block-row {r}: repeated block column")
        # shift s satisfies offset(row i) == (s + i) % Z; row 0 gives s.
        s = offs0.copy()
        # Exhaustive verification over all Z rows of this block-row.
        for i in range(Z):
            row = rows[r * Z + i]
            if len(row) != deg:
                raise ValueError(f"block-row {r}: ragged degree at row {i}")
            expect = cols0 * Z + (s + i) % Z
            # Entries within a row are sorted by block column in the flat
            # list; re-sort both for comparison.
            if not np.array_equal(np.sort(row), np.sort(expect)):
                raise ValueError(f"block-row {r}, row {i}: not a shifted identity")
            # Also check the column order is stable so message indexing is
            # consistent with the reference edge order.
            if not np.array_equal(row // Z, cols0):
                raise ValueError(f"block-row {r}, row {i}: column order changes")
        block_cols.append(cols0)
        shifts.append(s)
        degrees.append(deg)
    return block_cols, shifts, degrees


def pack(block_cols, shifts, degrees, max_deg: int):
    """Pad per-block-row entry lists to max_deg with a -1 sentinel."""
    n = len(block_cols)
    cols = np.full((n, max_deg), -1, dtype=np.int32)
    shf = np.zeros((n, max_deg), dtype=np.int32)
    for r in range(n):
        d = degrees[r]
        cols[r, :d] = block_cols[r]
        shf[r, :d] = shifts[r]
    return cols, shf, np.asarray(degrees, dtype=np.int32)


def main(ref_root: str) -> None:
    constants = Path(ref_root) / "Constants/50GPON-dc-original/Constants_SSE.h"
    flat = parse_pos_noeuds(constants)
    rows = rows_from_flat(flat)
    block_cols, shifts, degrees = extract_block_structure(rows)
    max_deg = max(degrees)
    cols, shf, deg = pack(block_cols, shifts, degrees, max_deg)

    # Column weights per VN (used by FAID weight buckets and DTBF).
    vn_weight = np.zeros(N_VAR, dtype=np.int32)
    np.add.at(vn_weight, flat, 1)

    out = Path(__file__).parent / "data" / "50gpon.npz"
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        out,
        z=np.int32(Z),
        n_var=np.int32(N_VAR),
        n_chk=np.int32(N_CHK),
        block_cols=cols,
        shifts=shf,
        degrees=deg,
        vn_weight=vn_weight,
        flat_edges=flat,  # kept for golden-model validation only
    )
    print(f"wrote {out}")
    print("degrees per block-row:", degrees)
    print("weight histogram:", np.bincount(vn_weight))

    cw = parse_reference_codeword(Path(ref_root) / "Codeword.h")
    cw_out = Path(__file__).parent / "data" / "50gpon_codeword.npz"
    np.savez_compressed(cw_out, codeword=cw)
    print(f"wrote {cw_out} (weight {int(cw.sum())})")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "/root/reference")
