"""Native golden decoder vs the numpy oracle, then wide-coverage parity
of the JAX decoders against the (fast) native oracle."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from faid.code.toy import toy_code
from faid.config import DecodeMethod, DecoderConfig
from faid.decoders.core import build_decoder
from faid.golden.model import decode_golden

native = pytest.importorskip("faid.utils.native")

# Method-0 rows deliberately pin the degenerate 1/6-factor NMS datapath;
# the footgun warning is expected there.
pytestmark = pytest.mark.filterwarnings("ignore:NMS normalization")

METHODS = list(DecodeMethod)


@pytest.fixture(scope="module")
def lib_ok():
    try:
        native.get_lib()
    except Exception as e:
        pytest.skip(f"native build unavailable: {e}")


def cfg_for(method, max_iter=4, bf_iter=4):
    dcfg = DecoderConfig.for_method(method, max_iter=max_iter)
    if dcfg.bf.kind != "none":
        dcfg = dataclasses.replace(
            dcfg, bf=dataclasses.replace(dcfg.bf, max_iter=bf_iter))
    return dcfg


@pytest.mark.parametrize("method", METHODS)
def test_native_matches_numpy_golden_toy(lib_ok, rng, method):
    code = toy_code()
    dcfg = cfg_for(method)
    for _ in range(6):
        llr = rng.integers(-7, 8, size=code.n_var).astype(np.int8)
        a = decode_golden(llr, code, dcfg)
        b = native.golden_decode_native(llr, code, dcfg)
        np.testing.assert_array_equal(a["hard"], b["hard"],
                                      err_msg=method.name)
        assert a["mp_iters"] == b["mp_iters"]
        assert a["bf_rounds"] == b["bf_rounds"]


@pytest.mark.parametrize("method", METHODS)
def test_native_matches_numpy_golden_full(lib_ok, rng, code, method):
    dcfg = cfg_for(method, max_iter=2, bf_iter=2)
    llr = rng.integers(-7, 8, size=code.n_var).astype(np.int8)
    a = decode_golden(llr, code, dcfg)
    b = native.golden_decode_native(llr, code, dcfg)
    np.testing.assert_array_equal(a["hard"], b["hard"], err_msg=method.name)
    assert a["mp_iters"] == b["mp_iters"]
    assert a["bf_rounds"] == b["bf_rounds"]


@pytest.mark.parametrize("method", METHODS)
def test_jax_wide_parity_vs_native(lib_ok, rng, code, method):
    """Many-frame full-code parity of the batched JAX decoder vs the
    native oracle - coverage the slow numpy oracle can't afford."""
    dcfg = cfg_for(method, max_iter=3, bf_iter=4)
    dec = jax.jit(build_decoder(code, dcfg))
    batch = 8
    # mix of adversarial random and realistic noisy-zero LLRs
    llr = rng.integers(-7, 8, size=(batch, code.n_var)).astype(np.int8)
    y = -1.0 + 0.7 * rng.standard_normal((batch // 2, code.n_var))
    llr[: batch // 2] = np.clip(np.trunc(y * 13.0), -7, 7).astype(np.int8)
    out = jax.tree.map(np.asarray, dec(jnp.asarray(llr)))
    for f in range(batch):
        g = native.golden_decode_native(llr[f], code, dcfg)
        np.testing.assert_array_equal(
            out["hard"][f].astype(np.uint8), g["hard"],
            err_msg=f"{method.name} frame {f}")
        assert out["mp_iters"][f] == g["mp_iters"]
        assert out["bf_rounds"][f] == g["bf_rounds"]
