"""Provenance: regenerating the code data from the reference header must
reproduce the committed npz exactly (skipped when the reference checkout
is absent)."""

from pathlib import Path

import numpy as np
import pytest

REF = Path("/root/reference")


@pytest.mark.skipif(not REF.exists(), reason="reference checkout absent")
def test_extract_reproduces_committed_npz(tmp_path, code):
    from faid.code import extract

    edges = extract.parse_pos_noeuds(
        REF / "Constants" / "50GPON-dc-original" / "Constants_SSE.h")
    assert edges.size == 70400
    # The committed QC form must regenerate the same flat edge list.
    np.testing.assert_array_equal(code.edge_list_np, edges)
