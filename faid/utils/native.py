"""ctypes bindings for the native (C++) host-side components.

The shared library is built lazily from ``native_src/`` with g++ -O3 and
cached next to the sources; no pip/pybind dependency.  Python fallbacks
exist for every function (see callers), so the framework works without a
compiler - the native path is a ~60x speedup for code-matrix tooling.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).parent / "native_src"
_LIB_PATH = _SRC / "libfaid.so"
_lock = threading.Lock()
_lib = None


def _build() -> None:
    srcs = sorted(str(p) for p in _SRC.glob("*.cpp"))
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
           "-o", str(_LIB_PATH), *srcs]
    subprocess.run(cmd, check=True, capture_output=True)


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        newest_src = max(p.stat().st_mtime for p in _SRC.glob("*.cpp"))
        if not _LIB_PATH.exists() or _LIB_PATH.stat().st_mtime < newest_src:
            _build()
        lib = ctypes.CDLL(str(_LIB_PATH))
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        c = ctypes.c_int
        lib.gf2_solve_parity.argtypes = [u8p, c, c, c, u8p]
        lib.gf2_solve_parity.restype = c
        lib.gf2_matmul_mod2.argtypes = [u8p, u8p, c, c, c, u8p]
        lib.gf2_matmul_mod2.restype = None
        lib.gf2_syndrome_weight.argtypes = [u8p, u8p, c, c, c, i32p]
        lib.gf2_syndrome_weight.restype = None
        i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
        lib.golden_decode.argtypes = (
            [i32p, i32p, i32p, c, c, c, i8p]          # code + llr
            + [c] * 11                                 # style..sign_backtrack
            + [ctypes.c_void_p, ctypes.c_void_p, c]    # lut, lut_ef, tail
            + [c] * 9                                  # bf config
            + [u8p, i32p, i32p])                       # outputs
        lib.golden_decode.restype = None
        _lib = lib
        return lib


def gf2_solve_parity(h: np.ndarray, n_info: int) -> np.ndarray:
    """P with parity = (P @ u) % 2; raises on singular H_p.
    Native equivalent of encoder.solve_parity_projection."""
    h = np.ascontiguousarray(h, dtype=np.uint8)
    n_chk, n_var = h.shape
    out = np.empty((n_chk, n_info), dtype=np.uint8)
    rc = get_lib().gf2_solve_parity(h, n_chk, n_var, n_info, out)
    if rc != 0:
        raise ValueError("H_p singular over GF(2)")
    return out


def gf2_matmul_mod2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a, dtype=np.uint8)
    b = np.ascontiguousarray(b, dtype=np.uint8)
    m, k = a.shape
    k2, n = b.shape
    assert k == k2
    out = np.empty((m, n), dtype=np.uint8)
    get_lib().gf2_matmul_mod2(a, b, m, k, n, out)
    return out


_BF_KINDS = {"none": 0, "static": 1, "dtbf": 2, "dtbf2b1c": 3}
_STYLES = {"nms": 0, "oms": 1, "faid": 2}


def golden_decode_native(llr: np.ndarray, code, dcfg) -> dict:
    """Native mirror of faid.golden.model.decode_golden (one frame).

    Bit-identical to the numpy oracle (tests/test_native_golden.py); ~100x
    faster, making wide-coverage parity tests cheap.
    """
    from ..decoders import luts as luts_mod

    lib = get_lib()
    style = _STYLES["nms" if dcfg.method.value == 0
                    else "oms" if dcfg.method.value in (1, 3, 4) else "faid"]
    if style == _STYLES["faid"]:
        lut = np.ascontiguousarray(
            luts_mod.table_for(dcfg.lut_family, dcfg.max_iter), dtype=np.int8)
        lut_ef = np.ascontiguousarray(
            luts_mod.ef_table(dcfg.max_iter), dtype=np.int8)
        lut_p = lut.ctypes.data_as(ctypes.c_void_p)
        lut_ef_p = lut_ef.ctypes.data_as(ctypes.c_void_p)
    else:
        lut = lut_ef = None
        lut_p = lut_ef_p = None

    degrees_per_cn = np.repeat(code.degrees_np,
                               [code.z] * code.n_block_rows).astype(np.int32)
    edges = np.ascontiguousarray(code.edge_list_np, dtype=np.int32)
    vn_weight = np.ascontiguousarray(code.vn_weight_np, dtype=np.int32)
    llr = np.ascontiguousarray(llr, dtype=np.int8)
    hard = np.empty(code.n_var, dtype=np.uint8)
    mp = np.zeros(1, dtype=np.int32)
    bf = np.zeros(1, dtype=np.int32)
    b = dcfg.bf
    lib.golden_decode(
        edges, degrees_per_cn, vn_weight,
        code.n_var, code.n_chk, code.n_edges, llr,
        style, dcfg.max_iter, dcfg.factor_1, dcfg.factor_2, dcfg.oms_mode,
        dcfg.oms_offset, int(dcfg.stop_early), dcfg.ef_elimination,
        dcfg.floor_err_count, dcfg.floor_iter_thresh,
        int(dcfg.sign_backtrack),
        lut_p, lut_ef_p, code.puncture_tail,
        _BF_KINDS[b.kind], b.max_iter, b.delta, b.l0, b.l1, b.alpha,
        b.gamma, b.static_vote_cap, b.reliability_threshold,
        hard, mp, bf)
    return {"hard": hard, "mp_iters": int(mp[0]), "bf_rounds": int(bf[0])}


def gf2_syndrome_weight(h: np.ndarray, c: np.ndarray) -> np.ndarray:
    h = np.ascontiguousarray(h, dtype=np.uint8)
    c = np.ascontiguousarray(c, dtype=np.uint8)
    n_chk, n_var = h.shape
    batch = c.shape[0]
    assert c.shape[1] == n_var
    out = np.empty((batch,), dtype=np.int32)
    get_lib().gf2_syndrome_weight(h, c, n_chk, n_var, batch, out)
    return out
