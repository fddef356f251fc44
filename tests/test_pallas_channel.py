"""Quantile-sampling channel (ops/quantile_channel.py).

These tests validate the parts that carry all the correctness weight:

  * the quantile thresholds against float64 erf,
  * the staircase semantics against the float chain
    (modulate -> AWGN -> demap -> quantize) it replaces,
  * the bit-1 mirror identity (exact integer property),
  * the output *distribution* against the analytic law,
  * the full sim-step wiring against the float-channel sim step at the
    statistics level.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from faid.config import DecodeMethod, SimConfig
from faid.ops import fixed_point as fp
from faid.ops import quantile_channel as pc


def _f64_thresholds(cfg, sigma):
    """Reference threshold computation in python float64."""
    a = pc._AMPLITUDE[cfg.mod_type]
    srail = sigma / math.sqrt(2.0) if cfg.mod_type == 2 else sigma
    offs = pc._step_offsets(cfg.quant_bits)

    def phi(t):  # standard normal CDF
        return 0.5 * (1.0 + math.erf(t / math.sqrt(2.0)))

    def small_to_int(p):
        return int(min(max(round(p * 2.0**32), 1), 2**31 - 256))

    A = [2**31 - small_to_int(phi(-(k / cfg.scale + a) / srail))
         for k in offs]
    B = []
    for k in offs:
        t = (a - k / cfg.scale) / srail
        if t > 0:
            B.append(2**31 - 1 - small_to_int(phi(-t)))
        else:
            B.append(-(2**31) + small_to_int(phi(t)) - 1)
    H = 2**31 - small_to_int(phi(-a / srail))
    return np.array(A + B + [H], np.int64)


@pytest.mark.parametrize("mod_type,quant_bits,sigma", [
    (2, 4, 0.335), (2, 4, 0.237), (1, 4, 0.41), (2, 2, 0.3), (2, 5, 0.35),
    (2, 6, 0.335),
])
def test_thresholds_vs_float64(mod_type, quant_bits, sigma):
    cfg = SimConfig(mod_type=mod_type, quant_bits=quant_bits)
    got = np.asarray(jax.jit(lambda s: pc._threshold_ints(cfg, s))(
        jnp.float32(sigma))).astype(np.int64)
    want = _f64_thresholds(cfg, sigma)
    # f32 ndtr carries ~1e-6 relative error on each step probability;
    # compare the distance-to-rail (the small-side probability in grid
    # units), which is what the tail accuracy story is about.
    for g, w in zip(got, want):
        small_g = min(2**31 - g, g + 2**31 + 1)
        small_w = min(2**31 - w, w + 2**31 + 1)
        assert abs(small_g - small_w) <= max(4, 1e-4 * small_w), (g, w)


def test_mirror_identity(rng):
    """llr(ix, bit=1) == -llr(ix ^ -1, bit=0), err identical — exact."""
    cfg = SimConfig(mod_type=2, quant_bits=4)
    params = jax.jit(lambda s: pc._threshold_ints(cfg, s))(jnp.float32(0.3))
    ix = jnp.asarray(rng.integers(-2**31, 2**31, (64, 256), np.int64)
                     .astype(np.int32))
    m1 = jnp.full(ix.shape, -1, jnp.int32)
    m0 = jnp.zeros(ix.shape, jnp.int32)
    llr1, err1 = pc.staircase(ix, m1, params, 4)
    llr0, err0 = pc.staircase(ix ^ -1, m0, params, 4)
    np.testing.assert_array_equal(np.asarray(llr1), -np.asarray(llr0))
    np.testing.assert_array_equal(np.asarray(err1), np.asarray(err0))


@pytest.mark.parametrize("bit,quant_bits", [(0, 4), (1, 4), (0, 6), (1, 6)])
def test_staircase_matches_float_chain(bit, rng, quant_bits):
    """Away from quantizer boundaries, the staircase output must equal
    the float chain exactly for the same underlying noise draw."""
    cfg = SimConfig(mod_type=2, quant_bits=quant_bits)
    sigma = 0.335
    srail = sigma / math.sqrt(2.0)
    a = pc._AMPLITUDE[2]

    z = rng.normal(size=200_000)
    soft = (a if bit else -a) + srail * z
    y = soft * cfg.scale
    # Exclude draws within 1e-3 of a quantizer step (integers for the
    # truncating quantizers, half-integers for 6-bit round-half-even)
    # or the sign boundary (there the f64->grid mapping below is
    # allowed to disagree).
    if quant_bits == 6:
        near_step = np.abs(np.abs(y - np.floor(y)) - 0.5) <= 1e-3
    else:
        near_step = np.abs(y - np.round(y)) <= 1e-3
    keep = ~near_step & (np.abs(soft) > 1e-4)
    z, soft = z[keep], soft[keep]

    want_llr = np.asarray(fp.quantize_llr(jnp.asarray(soft, jnp.float32),
                                          cfg.scale, quant_bits))
    want_err = ((soft > 0) != bool(bit)).astype(np.int8)

    # Map each z to its uniform grid word in float64.
    u = np.array([0.5 * (1.0 + math.erf(t / math.sqrt(2.0))) for t in z])
    ix = np.clip(np.round(u * 2.0**32 - 2**31), -2**31, 2**31 - 1)
    ix = jnp.asarray(ix.astype(np.int64).astype(np.int32)).reshape(1, -1)
    # For bit=1 the staircase mirrors internally (ix ^ mask), so the
    # same grid word represents the same underlying z in both cases.
    mask = jnp.full(ix.shape, -1 if bit else 0, jnp.int32)
    params = jax.jit(lambda s: pc._threshold_ints(cfg, s))(
        jnp.float32(sigma))
    got_llr, got_err = pc.staircase(ix, mask, params, quant_bits)
    got_llr = np.asarray(got_llr)[0]
    got_err = np.asarray(got_err)[0]

    # f32 threshold error can flip draws that sit within ~1e-6 of a
    # boundary in probability; demand 99.99% exact agreement and no
    # disagreement larger than one quantizer step.
    mism = got_llr != want_llr
    assert mism.mean() < 1e-4, mism.mean()
    assert np.abs(got_llr.astype(int) - want_llr.astype(int)).max() <= 1
    assert (got_err != want_err).mean() < 1e-4


def test_staircase_distribution(rng):
    """Empirical law of the staircase vs the analytic probabilities."""
    cfg = SimConfig(mod_type=2, quant_bits=4)
    sigma = 0.335
    params = jax.jit(lambda s: pc._threshold_ints(cfg, s))(
        jnp.float32(sigma))
    M = 2_000_000
    ix = jnp.asarray(rng.integers(-2**31, 2**31, (1, M), np.int64)
                     .astype(np.int32))
    llr, err = pc.staircase(ix, jnp.zeros((1, M), jnp.int32), params, 4)
    llr = np.asarray(llr)[0]

    w = _f64_thresholds(cfg, sigma).astype(np.float64)
    A, B = w[:7], w[7:14]
    # P(llr = v) from the threshold law (tx = -a).
    p_ge = np.array([1.0] + [(2**31 - t) / 2.0**32 for t in A])  # P(q>=k), k=0..7
    p_le = np.array([1.0] + [(t + 2**31 + 1) / 2.0**32 for t in B])
    probs = {}
    for v in range(0, 8):
        hi_p = p_ge[v] - (p_ge[v + 1] if v < 7 else 0.0)
        probs[v] = hi_p
    for v in range(1, 8):
        probs[-v] = p_le[v] - (p_le[v + 1] if v < 7 else 0.0)
    probs[0] -= p_le[1]          # q==0 band is between the two ladders
    for v in range(-7, 8):
        p = probs[v]
        emp = (llr == v).mean()
        tol = 6 * math.sqrt(max(p * (1 - p), 1e-12) / M) + 1e-6
        assert abs(emp - p) < tol, (v, emp, p, tol)
    assert abs(sum(probs.values()) - 1.0) < 1e-9


def test_sim_step_fused_vs_xla_statistics(code):
    """Full wiring: the fused-channel sim step must reproduce the float
    channel's pre-decoder BER and decoder behavior statistically."""
    from faid.sim.pipeline import build_sim_step

    base = dict(decode_method=DecodeMethod.FAID_DTBF, max_iteration=6,
                mod_type=2, batch_per_device=512, fake_encode=True,
                seed=0)
    cfg_x = SimConfig(**base, channel_backend="xla")
    cfg_f = SimConfig(**base, channel_backend="fused")
    sigma = jnp.float32(cfg_x.sigma_at(3.3))   # waterfall: plenty of errors
    sx = jax.jit(build_sim_step(code, cfg_x))
    sf = jax.jit(build_sim_step(code, cfg_f))
    ox = jax.device_get(sx(jax.random.key(7), sigma))
    of = jax.device_get(sf(jax.random.key(7), sigma))

    nbits = 512 * code.n_info
    bx, bf_ = ox["mod_error_bits"] / nbits, of["mod_error_bits"] / nbits
    # Two-proportion z-test on the pre-decoder BER (~8e-3 at 3.3 dB).
    pbar = (ox["mod_error_bits"] + of["mod_error_bits"]) / (2 * nbits)
    se = math.sqrt(2 * pbar * (1 - pbar) / nbits)
    assert abs(bx - bf_) < 6 * se, (bx, bf_, se)
    # Decoder sees an equivalent channel: mean MP iterations agree.
    ix_, if_ = ox["mp_iters"] / 512, of["mp_iters"] / 512
    assert abs(ix_ - if_) < 0.2, (ix_, if_)


def test_supports_gates(code):
    assert pc.supports(SimConfig(mod_type=2, quant_bits=4))
    assert pc.supports(SimConfig(mod_type=1, quant_bits=4))
    assert pc.supports(SimConfig(mod_type=4, quant_bits=4))
    assert pc.supports(SimConfig(mod_type=6, quant_bits=4))
    assert pc.supports(SimConfig(mod_type=8, quant_bits=4))
    # 6-bit round-half-even: covered since round 5 (half-integer steps).
    assert pc.supports(SimConfig(mod_type=2, quant_bits=6))
    assert not pc.supports(SimConfig(mod_type=2, quant_bits=1))
    with pytest.raises(ValueError):
        pc.build_fused_channel(code, SimConfig(mod_type=2, quant_bits=1))


# --------------------------- QAM (shared-draw plan) ---------------------


@pytest.mark.parametrize("mod_type", [1, 2, 4, 6, 8])
def test_reduce_mod_stats_matches_numpy(code, mod_type, rng):
    """Per-frame ModCalErr counts vs a numpy loop: info bits only (the
    parity tail is ignored) and a symbol = mod_type consecutive info
    bits, the last one zero-padded when mod_type does not divide
    n_info."""
    n, n_info = code.n_var, code.n_info
    err_map = (rng.random((8, n)) < 0.07).astype(np.int8)
    bits, syms = pc.reduce_mod_stats(jnp.asarray(err_map), n_info, mod_type)
    info = err_map[:, :n_info].astype(bool)
    want_syms = [sum(info[f, i:i + mod_type].any()
                     for i in range(0, n_info, mod_type))
                 for f in range(info.shape[0])]
    np.testing.assert_array_equal(np.asarray(bits), info.sum(axis=1))
    np.testing.assert_array_equal(np.asarray(syms), want_syms)
    assert int(np.asarray(bits).sum()) > 0


def test_qam_plan_matches_legacy_qpsk(rng):
    """mod_type=2 through the generalized plan must equal the legacy
    per-bit staircase bit-for-bit on the same draws (the plan machinery
    is a strict generalization)."""
    cfg = SimConfig(mod_type=2, quant_bits=4)
    sigma = jnp.float32(0.335)
    params_old = jax.jit(lambda s: pc._threshold_ints(cfg, s))(sigma)
    params_new = jax.jit(lambda s: pc._plan_threshold_ints(cfg, s))(sigma)
    assert params_new.shape[0] == 1                     # nmag == 1

    ix = jnp.asarray(rng.integers(-2**31, 2**31, (16, 512), np.int64)
                     .astype(np.int32))
    bit = jnp.asarray(rng.integers(0, 2, (16, 512)).astype(np.int32))
    mask = -bit

    llr_old, err_old = pc.staircase(ix, mask, params_old, 4)
    rows = [[params_new[0, j] for j in range(params_new.shape[1])]]
    qs, hards = pc.staircase_qam(ix, bit, [], rows, mod_type=2,
                                 quant_bits=4, scale=cfg.scale)
    np.testing.assert_array_equal(np.asarray(llr_old),
                                  np.asarray(qs[0]).astype(np.int8))
    np.testing.assert_array_equal(np.asarray(err_old),
                                  np.asarray(hards[0]).astype(np.int8))


@pytest.mark.parametrize("quant_bits", [4, 6])
def test_qam_joint_law_16qam(rng, quant_bits):
    """JOINT law of one rail's (q0, q1) vs the float chain: the two LLRs
    share a draw, so marginal agreement is not enough - a wrong shared-
    draw wiring shifts the joint histogram even with perfect marginals.
    quant_bits=6 covers the round-half-even half-integer plan offsets."""
    import math

    from faid.ops import modem
    cfg = SimConfig(mod_type=4, quant_bits=quant_bits)
    sigma = 0.35
    srail = sigma / math.sqrt(2.0)
    M = 400_000
    params = jax.jit(lambda s: pc._plan_threshold_ints(cfg, s))(
        jnp.float32(sigma))
    rows = [[params[m, j] for j in range(params.shape[1])]
            for m in range(2)]

    for sign_bit in (0, 1):
        for mag_bit in (0, 1):
            a = float(pc._MAGNITUDES[4][mag_bit])
            s_amp = a if sign_bit else -a
            # Float chain on explicit normal draws.
            z = rng.normal(size=M)
            y = np.float32(s_amp + srail * z)
            l1 = modem._fold_sub(jnp.abs(jnp.asarray(y)),
                                 modem._FOLD[4][0])
            q0_f = np.asarray(fp.quantize_llr(jnp.asarray(y), cfg.scale,
                                              quant_bits))
            q1_f = np.asarray(fp.quantize_llr(l1, cfg.scale, quant_bits))

            # Quantile path on the SAME z mapped to grid words.
            u = 0.5 * (1.0 + np.vectorize(math.erf)(z / math.sqrt(2.0)))
            ix = np.clip(np.round(u * 2.0**32 - 2**31), -2**31,
                         2**31 - 1).astype(np.int64).astype(np.int32)
            sb = jnp.full((M,), sign_bit, jnp.int32)
            mb = jnp.full((M,), mag_bit, jnp.int32)
            qs, _ = pc.staircase_qam(jnp.asarray(ix), sb, [mb], rows,
                                     mod_type=4, quant_bits=quant_bits,
                                     scale=cfg.scale)
            q0_g, q1_g = np.asarray(qs[0]), np.asarray(qs[1])

            # Same-draw pathwise agreement (away from boundaries the map
            # is deterministic; allow the boundary-ulp flips).
            mism = ((q0_g != q0_f) | (q1_g != q1_f)).mean()
            assert mism < 2e-4, (sign_bit, mag_bit, mism)


def test_sim_step_fused_vs_xla_statistics_16qam(code):
    """Full pipeline wiring for QAM incl. the interleave wrapper: fused
    vs float channel at the statistics level (pre-decoder BER and mean
    MP iterations), 16-QAM depth 2."""
    import math

    from faid.sim.pipeline import build_sim_step

    base = dict(decode_method=DecodeMethod.FAID_DTBF, max_iteration=6,
                mod_type=4, interleave_depth=2, batch_per_device=256,
                fake_encode=True, seed=0)
    cfg_x = SimConfig(**base, channel_backend="xla")
    cfg_f = SimConfig(**base, channel_backend="fused")
    sigma = jnp.float32(cfg_x.sigma_at(7.6))   # 16-QAM waterfall
    sx = jax.jit(build_sim_step(code, cfg_x))
    sf = jax.jit(build_sim_step(code, cfg_f))
    ox = jax.device_get(sx(jax.random.key(11), sigma))
    of = jax.device_get(sf(jax.random.key(11), sigma))

    nbits = 256 * code.n_info
    bx, bf_ = ox["mod_error_bits"] / nbits, of["mod_error_bits"] / nbits
    pbar = (ox["mod_error_bits"] + of["mod_error_bits"]) / (2 * nbits)
    se = math.sqrt(2 * pbar * (1 - pbar) / nbits)
    assert abs(bx - bf_) < 6 * se, (bx, bf_, se)
    ix_, if_ = ox["mp_iters"] / 256, of["mp_iters"] / 256
    assert abs(ix_ - if_) < 0.3, (ix_, if_)
