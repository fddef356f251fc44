"""The XLA decoder vs the scalar numpy golden model on the toy code: all
six methods, three LLR families, both early-stop granularities.

The golden model decodes one frame with per-frame early stop.  Group
mode (the reference's 32-frame-word rule) is checked on groups of 32
copies of one frame, where the group rule reduces to the frame rule:
two such groups per batch, so the test also shows that one group's exit
does not touch the other."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from faid.code.toy import toy_code
from faid.config import DecodeMethod, DecoderConfig
from faid.decoders.core import build_decoder, build_stats_decoder
from faid.golden.model import decode_golden


def small_cfg(method, stop_mode, max_iter=4, bf_iter=3):
    # NMS gets its own 26/32 factors: the shared Profile default 1/6
    # floors the NMS normalization to zero (decoders/core.py warning).
    kw = dict(factor_1=26, factor_2=32) if method == DecodeMethod.NMS else {}
    dcfg = DecoderConfig.for_method(method, max_iter=max_iter,
                                    stop_mode=stop_mode, **kw)
    if dcfg.bf.kind != "none":
        dcfg = dataclasses.replace(
            dcfg, bf=dataclasses.replace(dcfg.bf, max_iter=bf_iter))
    return dcfg


def llrs(kind, n_frames, n_var, rng):
    if kind == "random7":          # 4-bit quantizer range
        return rng.integers(-7, 8, size=(n_frames, n_var)).astype(np.int8)
    if kind == "full31":           # 6-bit quantizer range
        return rng.integers(-31, 32, size=(n_frames, n_var)).astype(np.int8)
    # noisy all-zero codeword over BPSK AWGN, 4-bit quantized
    y = -1.0 + 0.8 * rng.standard_normal((n_frames, n_var))
    return np.clip(np.trunc(y * 13.0), -7, 7).astype(np.int8)


@pytest.mark.parametrize("stop_mode", ["frame", "group"])
@pytest.mark.parametrize("kind", ["random7", "full31", "noisy"])
@pytest.mark.parametrize("method", list(DecodeMethod))
def test_xla_decoder_matches_golden(rng, method, kind, stop_mode):
    code = toy_code()
    dcfg = small_cfg(method, stop_mode)
    if stop_mode == "frame":
        frames = llrs(kind, 8, code.n_var, rng)
        batch = frames
    else:
        frames = llrs(kind, 2, code.n_var, rng)
        batch = np.repeat(frames, 32, axis=0)
    out = jax.tree.map(np.asarray,
                       jax.jit(build_decoder(code, dcfg))(jnp.asarray(batch)))
    stats = jax.tree.map(np.asarray, jax.jit(build_stats_decoder(code, dcfg))(
        jnp.asarray(batch)))
    per = 1 if stop_mode == "frame" else 32
    for f in range(frames.shape[0]):
        g = decode_golden(frames[f], code, dcfg)
        for row in range(f * per, (f + 1) * per):
            np.testing.assert_array_equal(
                out["hard"][row].astype(np.uint8), g["hard"],
                err_msg=f"{method.name} {kind} frame {f} row {row}")
            assert out["mp_iters"][row] == g["mp_iters"], (f, row)
            assert out["bf_rounds"][row] == g["bf_rounds"], (f, row)
            assert stats["err_bits"][row] == g["hard"][:code.n_info].sum()
    np.testing.assert_array_equal(stats["mp_iters"], out["mp_iters"])
    np.testing.assert_array_equal(stats["bf_rounds"], out["bf_rounds"])
