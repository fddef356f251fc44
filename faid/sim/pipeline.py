"""One jitted Monte-Carlo step: encode -> modulate -> AWGN -> demodulate ->
quantize -> decode -> count errors, batched over frames.

This is the batched re-design of the reference's per-thread worker loop
``CSimulate::Run`` (reference CSimulate.cpp:92-180): the reference runs one
32-frame SIMD group x 50 rounds per pthread; here one ``sim_step`` call
processes an arbitrary frame batch, and both the SIMD-lane axis and the
thread axis become the leading batch dimension (shardable over a device
mesh, see parallel/mesh.py).

Statistics reproduce ``CalculateErrors`` (reference CLDPC.cpp:4819-4995)
and the pre-decoder ``ModCalErr`` counter (CModulate.cpp:382-491):
  error_bits       decoded info-bit errors (first NmoinsK bits)
  error_frames     frames with >= 1 info-bit error
  lt3_frames       error frames with < 3 bit errors (error-floor events)
  mod_error_bits/symbols/frames   hard-decision errors *before* decoding
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from ..code.encoder import make_encode_fn
from ..code.qc_matrix import QCCode
from ..config import SimConfig
from ..decoders.core import build_decoder, build_stats_decoder
from ..ops import channel, modem, quantile_channel
from ..ops import fixed_point as fp
from ..utils import vma


def _random_message_bits(key: jax.Array, batch: int,
                         n_info: int) -> jnp.ndarray:
    """iid Bernoulli(1/2) message bits [batch, n_info] int8.

    One threefry word yields 32 bits (jax.random.bernoulli burns a full
    uniform per bit).  Statistically identical source; the reference's
    GenMsgSeq is rand()%2 (CLDPC.cpp:60-66), and RNG streams are a
    documented deviation."""
    if n_info % 32:
        return jax.random.bernoulli(key, 0.5,
                                    (batch, n_info)).astype(jnp.int8)
    words = jax.random.bits(key, (batch, n_info // 32), jnp.uint32)
    shifts = jnp.arange(32, dtype=jnp.uint32)[None, None, :]
    return ((words[:, :, None] >> shifts) & 1).astype(jnp.int8).reshape(
        batch, n_info)


def _histogram(x: jnp.ndarray, length: int) -> jnp.ndarray:
    """bincount(clip(x, 0, length-1), length) via a compare matrix - a
    [batch, length] broadcast-compare + column sum instead of a
    scatter-add."""
    edges = jnp.arange(length, dtype=x.dtype)
    return (jnp.clip(x, 0, length - 1)[:, None]
            == edges[None, :]).sum(axis=0).astype(jnp.int32)


def build_front_end(code: QCCode, cfg: SimConfig) -> Callable:
    """Returns front(cw, key, sigma) -> (llr int8[b, n], mod_err[b, >=
    n_info], soft float32[b, n]): interleave -> modulate -> AWGN ->
    demap -> deinterleave -> quantize, plus the pre-decoder hard-decision
    error map (ModCalErr) and the pre-quantizer float LLRs.

    channel_backend='fused' draws through the quantile staircase
    (ops/quantile_channel.py), which has no float LLR: ``soft`` is then
    the dequantized llr/scale.  Configs outside its coverage fall back to
    the float chain with a warning (the two are statistically
    identical)."""
    n_info = code.n_info
    mod = cfg.mod_type
    if cfg.channel_backend == "fused":
        if quantile_channel.supports(cfg):
            fused = quantile_channel.build_fused_channel(code, cfg)

            def front_fused(cw, key, sigma):
                llr, mod_err = fused(cw, key, sigma)
                return llr, mod_err, llr.astype(jnp.float32) / cfg.scale

            return front_fused
        import warnings

        warnings.warn(
            f"channel_backend='fused' is not supported for this config "
            f"(mod_type={cfg.mod_type}, quant_bits={cfg.quant_bits}); "
            f"falling back to the float chain.", stacklevel=3)

    def front(cw, key, sigma):
        tx_bits = modem.interleave(cw, cfg.interleave_depth)
        if mod == 1:
            sym = modem.modulate_bpsk(tx_bits)
            soft = modem.demodulate_bpsk(channel.awgn_real(key, sym, sigma))
        else:
            sym = modem.modulate_qam(tx_bits, mod)
            # Complex noise: sigma/sqrt(2) per rail (reference
            # CSimulate.cpp:126).
            rx = channel.awgn_complex(key, sym, sigma / jnp.sqrt(2.0))
            soft = modem.demodulate_qam(rx, mod)
        soft = modem.deinterleave(soft, cfg.interleave_depth)
        llr = fp.quantize_llr(soft, cfg.scale, cfg.quant_bits)
        mod_err = jnp.logical_xor(soft[:, :n_info] > 0,
                                  cw[:, :n_info].astype(jnp.bool_))
        return llr, mod_err, soft

    return front


def _build_codewords(code: QCCode, cfg: SimConfig) -> Callable:
    """Returns codewords(k_msg) -> cw int8[batch, n_var]: the all-zero
    codeword (reference FakeEncoder, CLDPC.cpp:163) or random messages
    through the GF(2) encoder."""
    batch = cfg.batch_per_device
    if cfg.fake_encode:
        return lambda k_msg: jnp.zeros((batch, code.n_var), jnp.int8)
    encode = make_encode_fn(code)
    return lambda k_msg: encode(
        _random_message_bits(k_msg, batch, code.n_info))


def build_sim_step(code: QCCode, cfg: SimConfig) -> Callable:
    """Returns step(key, sigma) -> dict of int32 scalar counters.

    ``key`` is a jax PRNG key; ``sigma`` is the traced noise std-dev so one
    compiled executable serves the whole SNR sweep.
    """
    dcfg = cfg.decoder()
    batch = cfg.batch_per_device
    n_info = code.n_info
    codewords = _build_codewords(code, cfg)
    front = build_front_end(code, cfg)
    decoder = build_stats_decoder(code, dcfg)

    def step(key: jax.Array, sigma: jax.Array) -> dict:
        k_msg, k_noise = jax.random.split(key)
        cw = codewords(k_msg)
        llr, mod_err, _ = front(cw, k_noise, sigma)
        mod_error_bits, mod_error_symbols = quantile_channel.reduce_mod_stats(
            mod_err, n_info, cfg.mod_type)
        # With fake_encode the expected info word is all-zero.
        out = decoder(llr, None if cfg.fake_encode else cw[:, :n_info])
        err_bits = out["err_bits"]
        frame_err = err_bits > 0

        # Iteration histograms (the reference appends the remaining-BF-iter
        # histogram to iterCount.txt, CSimulate.cpp:171-179).
        bf_cap = max(dcfg.bf.max_iter, 1)
        return {
            "test_frames": jnp.int32(batch),
            "error_bits": err_bits.sum(),
            "error_frames": frame_err.sum().astype(jnp.int32),
            "lt3_frames": (frame_err & (err_bits < 3)).sum().astype(jnp.int32),
            "mod_error_bits": mod_error_bits.sum(),
            "mod_error_symbols": mod_error_symbols.sum(),
            "mod_error_frames": (mod_error_bits > 0).sum().astype(jnp.int32),
            "mp_iters": out["mp_iters"].sum(),
            "bf_rounds": out["bf_rounds"].sum(),
            "mp_hist": _histogram(out["mp_iters"], dcfg.max_iter + 1),
            "bf_hist": _histogram(out["bf_rounds"], bf_cap + 1),
        }

    return step


def build_debug_step(code: QCCode, cfg: SimConfig) -> Callable:
    """Forensic replay step: same datapath as build_sim_step but returns
    per-frame arrays instead of counters.  Because every noise draw is a
    pure function of the key, any Monte-Carlo round can be replayed
    exactly to dump its failing frames - the equivalent of the
    reference's errorindex/errorfloat/errordecode.txt dumps
    (CLDPC.cpp:4877-4991) without instrumenting the hot path.

    Returns debug(key, sigma) -> dict(err_bits[b], mp_iters[b],
    bf_rounds[b], hard[b, n_var] bool, cw[b, n_var] int8,
    llr[b, n_var] int8, soft[b, n_var] float32).
    """
    n_info = code.n_info
    codewords = _build_codewords(code, cfg)
    front = build_front_end(code, cfg)
    decoder = build_decoder(code, cfg.decoder())

    def debug(key: jax.Array, sigma: jax.Array) -> dict:
        k_msg, k_noise = jax.random.split(key)
        cw = codewords(k_msg)
        llr, _, soft = front(cw, k_noise, sigma)
        out = decoder(llr)
        err = jnp.logical_xor(out["hard"][:, :n_info],
                              cw[:, :n_info].astype(jnp.bool_))
        return {
            "err_bits": err.sum(axis=1).astype(jnp.int32),
            "mp_iters": out["mp_iters"],
            "bf_rounds": out["bf_rounds"],
            "hard": out["hard"],
            "cw": cw,
            "llr": llr,
            # Pre-quantizer float LLRs: the reference's errorfloat.txt
            # dump (CLDPC.cpp:4877-4991 records the channel float of
            # every erroneous bit).
            "soft": soft.astype(jnp.float32),
        }

    return debug


def build_sim_loop(code: QCCode, cfg: SimConfig, rounds: int) -> Callable:
    """Returns loop(key, sigma, round0) -> summed counters over ``rounds``
    consecutive Monte-Carlo rounds, accumulated ON DEVICE with a
    ``lax.fori_loop``.

    One host sync per ``rounds`` batches instead of per batch - the
    counterpart of the reference's 50-rounds-per-pthread-dispatch
    granularity (CSimulate.cpp:117).  Round ``i`` uses
    ``fold_in(key, round0 + i)``, so results are identical to calling
    the single step ``rounds`` times with those keys.
    """
    step = build_sim_step(code, cfg)

    def loop(key: jax.Array, sigma: jax.Array, round0: jax.Array) -> dict:
        def body(i, acc):
            stats = step(jax.random.fold_in(key, round0 + i), sigma)
            return jax.tree.map(jnp.add, acc, stats)

        # Zero initial counters cast to the key's device-varying type so
        # the fori_loop carry typechecks under shard_map (utils/vma.py).
        init = {k: vma.pvary_like(jnp.int32(0), key) for k in (
            "test_frames", "error_bits", "error_frames", "lt3_frames",
            "mod_error_bits", "mod_error_symbols", "mod_error_frames",
            "mp_iters", "bf_rounds")}
        dcfg = cfg.decoder()
        bf_cap = max(dcfg.bf.max_iter, 1)
        init["mp_hist"] = vma.pvary_like(
            jnp.zeros(dcfg.max_iter + 1, jnp.int32), key)
        init["bf_hist"] = vma.pvary_like(
            jnp.zeros(bf_cap + 1, jnp.int32), key)
        return jax.lax.fori_loop(0, rounds, body, init)

    return loop


def sigma_for(cfg: SimConfig, snr_db: float) -> float:
    """Noise sigma from Eb/N0 (reference CSimulate.cpp:67-91)."""
    return cfg.sigma_at(snr_db)
