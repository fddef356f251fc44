"""Quantile-sampling channel: modulate + AWGN + demap + quantize in ONE
elementwise pass, with no floating-point noise materialized at all.

For BPSK/QPSK the whole front end collapses per bit: the demapped soft
value is ``soft = s*a + sigma_rail*z`` (s = +-1 from the transmitted
bit, z ~ N(0,1)), and everything downstream consumes only

  * the quantized LLR  ``q = clip(trunc(scale*soft), lo, hi)``  and
  * the hard decision  ``soft > 0``  (pre-decoder ModCalErr stats),

both of which are monotone staircase functions of z.  So instead of
generating a Gaussian and pushing it through the float chain, draw ONE
uniform 32-bit word u per bit and compare it against the precomputed
quantile thresholds Phi^-1 of each staircase step:

  P(q >= k) = P(z >= (k/scale - s*a)/sigma_rail) = P(u >= Phi(t_k))

The output distribution is then EXACTLY the marginal of the reference
chain (reference CModulate.cpp:216-362 demap + CLDPC.cpp:4385-4770
truncating quantizer) up to the 2^-32 uniform grid and ~1e-7 relative
error of the float32 normal CDF on each step probability -- tail steps
are computed via the complement (ndtr(-t)) so the *relative* tail
accuracy survives.  This is strictly tighter than simulating float32
noise, whose own Box-Muller/erfinv tails carry comparable error.

Bit-1 symmetry: trunc and the +-L saturation are odd-symmetric, so
``q(+a, z) = -q(-a, -z)``; the staircase mirrors the uniform grid
(ix ^ -1 == reflecting u -> 1-u) and negates the output instead of
keeping a second threshold set.  Asymmetric final limits (3/5-bit
quantizers, e.g. clip to [-4, 3]) are applied after the sign restore.

The uniform words are ``jax.random.bits`` (threefry), so the channel
draws a different random stream than the float chain but the identical
marginal distribution; see README "Fidelity contract".  Forensic exact
replay regenerates the same stream from the round key.

16/64/256-QAM: the folded max-log demap makes the mod/2 LLRs of one
I/Q rail deterministic functions of ONE noise draw, so the rail draws a
single uniform and evaluates every level's quantized LLR as a staircase
of it -- the exact JOINT law, not only marginals (see the "QAM
generalization" section).  The rail grouping lives on the interleaved
bit order, so the wrapper applies interleave/deinterleave around it.

Statistical validation: tests/test_pallas_channel.py (thresholds vs
float64 erf; multinomial test of the staircase outputs against the
analytic law; exact mirror identity; end-to-end rate agreement with the
float-path channel; QAM: plan==legacy tie on QPSK, joint-law pathwise
agreement with the float chain on shared draws) and the FER z-test of
scripts/channel_parity.py.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..code.qc_matrix import QCCode
from ..ops.fixed_point import _QUANT_LIMITS
from . import modem

_AMPLITUDE = {1: 1.0, 2: 0.707107}   # BPSK; QPSK rail (CModulate.cpp:4)

# QAM rail magnitudes, indexed by the Gray magnitude index m (= the
# rail's bits after the sign bit, first-transmitted = MSB of m): the
# amplitude tables are sign-symmetric halves, table[2^(h-1) + m] ==
# -table[m] (reference CModulate.cpp:4-7), so |amplitude| = the positive
# half in order.
_MAGNITUDES = {
    2: np.abs(modem.TABLE_QPSK[1:]).astype(np.float64),   # plan<->legacy tie
    4: np.abs(modem.TABLE_16QAM[2:]).astype(np.float64),
    6: np.abs(modem.TABLE_64QAM[4:]).astype(np.float64),
    8: np.abs(modem.TABLE_256QAM[8:]).astype(np.float64),
}


def supports(cfg) -> bool:
    """True if the quantile channel covers this configuration.

    BPSK/QPSK sample each bit independently; 16/64/256-QAM share one
    draw per I/Q rail and evaluate every level's staircase on it
    (exact joint law - see the QAM section below).  For BPSK/QPSK the
    interleave pair is transparent (one bit per LLR); for QAM the
    wrapper applies interleave/deinterleave around the staircase."""
    # 2-5 bit: truncating quantizers; 6-bit: round-half-even over +-31
    # (reference float2LimitChar_6bit, CLDPC.cpp:4385-4463) - same
    # staircase machinery with half-integer step offsets (_step_offsets).
    return cfg.mod_type in (1, 2, 4, 6, 8) and cfg.quant_bits in (2, 3, 4, 5, 6)


def _step_offsets(quant_bits: int) -> np.ndarray:
    """float64[L] quantizer step positions: {q >= k} <=> {y > off[k-1]}.

    Truncating quantizers (2-5 bit, cvttps_epi32) step at the integers;
    the 6-bit quantizer rounds half-to-even (cvtps_epi32,
    CLDPC.cpp:4385-4463), so its steps sit at the half-integers k - 1/2.
    The tie y == k - 1/2 itself has probability ~0 under the continuous
    law (the strict staircase compare books it low, round-half-even
    books half of them high; the discrepancy is far below the float32
    ndtr error already accepted on every step probability)."""
    lo, hi = _QUANT_LIMITS[quant_bits]
    L = max(hi, -lo)
    ks = np.arange(1, L + 1, dtype=np.float64)
    return ks - 0.5 if quant_bits == 6 else ks


def _sigma_rail(cfg, sigma):
    # QPSK/QAM split the complex noise power over I/Q
    # (CSimulate.cpp:126: AWGNChannel(sigma/sqrt(2))).
    if cfg.mod_type == 1:
        return sigma
    return sigma / jnp.sqrt(jnp.float32(2.0))


def _threshold_ints(cfg, sigma) -> jnp.ndarray:
    """int32[2L+1] staircase thresholds on the uniform int32 grid for a
    transmitted '0' bit (amplitude -a): [A_1..A_L, B_1..B_L, H] with
    STRICT compares

      q >= k      <=>  ix >  A_k
      q <= -k     <=>  ix <  B_k
      soft > 0    <=>  ix >  H      (pre-decoder hard decision)

    where ix is a uniform int32 (u = (ix + 2^31)/2^32).  Tail-accurate:
    every probability is evaluated on its small side with ndtr,
    round-to-nearest onto the 2^-32 grid, and converted with exact
    integer arithmetic.  Strict compares let a step whose probability
    rounds to 0 (p < 2^-33) saturate to an UNREACHABLE threshold
    (INT32_MAX / INT32_MIN) instead of being clamped up to one grid
    unit - deep-floor campaigns no longer see spurious ~2.3e-10/bit
    max-magnitude wrong LLRs that the float chain essentially never
    produces."""
    a = jnp.float32(_AMPLITUDE[cfg.mod_type])
    srail = _sigma_rail(cfg, jnp.float32(sigma))
    inv_scale = jnp.float32(1.0 / cfg.scale)
    k = jnp.asarray(_step_offsets(cfg.quant_bits), jnp.float32)

    two32 = jnp.float32(4294967296.0)
    xmax = jnp.float32(2**31 - 256)          # f32-representable clamp

    def grid(p):
        # round(p * 2^32) onto the uniform grid; 0 allowed (step never
        # fires through the strict compare).
        return jnp.clip(jnp.rint(p * two32), 0.0, xmax).astype(jnp.int32)

    def grid1(p):
        # variant clamped to >= 1 for the one complement-side use where
        # count 0 would overflow int32 (and is not a tail event).
        return jnp.clip(jnp.rint(p * two32), 1.0, xmax).astype(jnp.int32)

    ndtr = jax.scipy.special.ndtr

    # A_k: t = (k/scale + a)/srail > 0 always; P(z >= t) = ndtr(-t);
    # exactly grid(p) of the 2^32 ix values satisfy ix > A_k.
    t_a = (k * inv_scale + a) / srail
    A = jnp.int32(2**31 - 1) - grid(ndtr(-t_a))

    # B_k: t' = (a - k/scale)/srail, sign depends on k and scale.
    t_b = (a - k * inv_scale) / srail
    #   t' > 0:  P(z <= t') = 1 - ndtr(-t') is large; the small side is
    #   the complement, so count-0 would mean B = INT32_MAX + 1 - keep
    #   the >=1 clamp here (bias 2^-32 on a near-certain step).
    T_pos = jnp.int32(2**31 - 1) - grid1(ndtr(-t_b)) + 1
    #   t' <= 0: P(z <= t') = ndtr(t') small; grid 0 -> B = INT32_MIN,
    #   unreachable via ix < B.
    T_neg = jnp.int32(-(2**31)) + grid(ndtr(t_b))
    B = jnp.where(t_b > 0, T_pos, T_neg)

    # H: soft > 0  <=>  z > a/srail.
    H = jnp.int32(2**31 - 1) - grid(ndtr(-a / srail))

    return jnp.concatenate([A, B, H[None]])


def staircase(ix: jnp.ndarray, mask: jnp.ndarray, params,
              quant_bits: int):
    """Uniform int32 words -> (int8 LLR, int8 mod_err).

    ``mask`` is 0 for a transmitted 0-bit, -1 for a 1-bit (mirrors the
    uniform grid via XOR).  ``params`` are the _threshold_ints."""
    lo, hi = _QUANT_LIMITS[quant_bits]
    L = max(hi, -lo)
    ixe = ix ^ mask
    q = jnp.zeros(ix.shape, jnp.int32)
    for i in range(L):
        q = q + (ixe > params[i]).astype(jnp.int32)
        q = q - (ixe < params[L + i]).astype(jnp.int32)
    q = (q ^ mask) - mask                      # restore the bit's sign
    if -lo != hi:                              # asymmetric final clip
        q = jnp.clip(q, lo, hi)
    err = (ixe > params[2 * L]).astype(jnp.int8)
    return q.astype(jnp.int8), err


# ---------------------------------------------------------------------
# QAM generalization (16/64/256-QAM): the folded max-log demap makes the
# mod/2 LLRs of one rail share a single noise draw, so per-bit quantile
# sampling does not apply - but the JOINT law is preserved by drawing
# ONE uniform per rail and evaluating every level's quantized LLR as a
# staircase of that shared draw.  Level l's soft value is
#
#   L_0 = y = s + sigma_rail*z,   L_l = |L_{l-1}| - c_l
#
# (reference CModulate.cpp:270-362), so {L_l >= t} expands recursively
# into a union of disjoint y-intervals whose endpoints are STATIC
# (functions of the fold constants and k/scale only); sigma enters only
# through the interval-endpoint -> int32-grid-threshold conversion, and
# the transmitted rail magnitude through a per-element select among the
# nmag = 2^(mod/2-1) precomputed threshold sets.  The sign bit is
# handled by the same ix-mirror as BPSK/QPSK: |y| is mirror-invariant,
# so only the level-0 staircase needs the sign restore.
#
# Float-rounding caveat: endpoints are real-valued inversions of the
# fold chain; the reference's compensated float32 folds (_fold_sub)
# put each fold boundary within 1 ulp, shifting step probabilities by
# O(density * ulp) ~ 1e-7 relative - the same error class as the
# float32 ndtr already accepted on every step.

_INF = float("inf")


def _isect(a, b):
    """Intersection of two disjoint-interval lists (each sorted)."""
    out = []
    for lo1, hi1 in a:
        for lo2, hi2 in b:
            lo, hi = max(lo1, lo2), min(hi1, hi2)
            if lo < hi:
                out.append((lo, hi))
    return out


def _expand_ge(level, t, folds):
    """y-intervals of {L_level >= t} (real-valued semantics)."""
    if level == 0:
        return [(t, _INF)]
    u = folds[level - 1] + t
    if u <= 0:
        return [(-_INF, _INF)]          # |L_{level-1}| >= u always holds
    return (_expand_ge(level - 1, u, folds)
            + _expand_le(level - 1, -u, folds))


def _expand_le(level, t, folds):
    """y-intervals of {L_level <= t}."""
    if level == 0:
        return [(-_INF, t)]
    u = folds[level - 1] + t
    if u < 0:
        return []                       # |L_{level-1}| <= u impossible
    return _isect(_expand_ge(level - 1, -u, folds),
                  _expand_le(level - 1, u, folds))


@functools.lru_cache(maxsize=None)
def _plan(mod_type: int, quant_bits: int, scale: float):
    """Static staircase plan for one QAM rail.

    Returns (levels, defs) where ``defs`` is the deduplicated parameter
    list [('gt'|'lt', x), ...] (x = static float endpoint; 'gt' needs
    threshold T with {ix > T} <=> {y > x}, 'lt' with {ix < T} <=> {y <
    x}) and ``levels[l]`` is a dict with interval lists per event, each
    interval as (lo_param_idx | None, hi_param_idx | None) - None for an
    infinite end - plus ``base`` (count of always-true >= steps):
      pos[k-1]: {L_l >= k/scale},  neg[k-1]: {L_l <= -k/scale},
      hard:     {L_l > 0}."""
    folds = tuple(modem._FOLD[mod_type])
    defs: list[tuple[str, float]] = []
    index: dict[tuple[str, float], int] = {}

    def ref(kind, x):
        key = (kind, float(x))
        if key not in index:
            index[key] = len(defs)
            defs.append(key)
        return index[key]

    def compile_event(intervals):
        out, base = [], 0
        for lo_x, hi_x in intervals:
            if lo_x == -_INF and hi_x == _INF:
                base += 1
                continue
            out.append((None if lo_x == -_INF else ref("gt", lo_x),
                        None if hi_x == _INF else ref("lt", hi_x)))
        return tuple(out), base

    levels = []
    for lev in range(mod_type // 2):
        pos, neg, base = [], [], 0
        for off in _step_offsets(quant_bits):
            iv, b = compile_event(_expand_ge(lev, off / scale, folds))
            pos.append(iv)
            base += b
            iv, b = compile_event(_expand_le(lev, -off / scale, folds))
            assert b == 0   # a <= event can never cover the whole line
            neg.append(iv)
        hard, hb = compile_event(_expand_ge(lev, 0.0, folds))
        assert hb == 0      # folds are positive, so {L_l > 0} is proper
        levels.append({"pos": tuple(pos), "neg": tuple(neg),
                       "hard": hard, "base": base})
    return tuple(levels), tuple(defs)


def _plan_threshold_ints(cfg, sigma) -> jnp.ndarray:
    """int32[nmag, nparam] thresholds for the rail plan, one row per
    Gray magnitude index, computed for a transmitted '0' sign bit
    (amplitude -a_m); tail-accurate on the 2^-32 grid with strict
    compares exactly like _threshold_ints."""
    _, defs = _plan(cfg.mod_type, cfg.quant_bits, float(cfg.scale))
    mags = _MAGNITUDES[cfg.mod_type]
    srail = _sigma_rail(cfg, jnp.float32(sigma))
    s = jnp.asarray(-mags, jnp.float32)[:, None]          # [nmag, 1]
    xs = jnp.asarray([x for _, x in defs], jnp.float32)[None, :]
    t = (xs - s) / srail                                  # [nmag, nparam]

    two32 = jnp.float32(4294967296.0)
    xmax = jnp.float32(2**31 - 256)
    ndtr = jax.scipy.special.ndtr

    def grid(p):
        return jnp.clip(jnp.rint(p * two32), 0.0, xmax).astype(jnp.int32)

    def grid1(p):
        return jnp.clip(jnp.rint(p * two32), 1.0, xmax).astype(jnp.int32)

    imax, imin = jnp.int32(2**31 - 1), jnp.int32(-(2**31))
    # {ix > T} <=> {y > x}: P small-side on whichever tail applies.
    t_gt = jnp.where(t > 0, imax - grid(ndtr(-t)),
                     imin + grid1(ndtr(t)) - 1)
    # {ix < T} <=> {y < x}.
    t_lt = jnp.where(t < 0, imin + grid(ndtr(t)),
                     imax - grid1(ndtr(-t)) + 1)
    is_gt = jnp.asarray([k == "gt" for k, _ in defs])[None, :]
    return jnp.where(is_gt, t_gt, t_lt)


def _eval_level(ixe, level_plan, P):
    """One level's staircase on the mirrored shared draw.

    ``P`` maps param index -> per-element int32 threshold array (already
    magnitude-selected).  Returns (q int32 BEFORE the asymmetric clip
    and BEFORE the level-0 sign restore, hard indicator int32 0/1)."""
    def ind(iv):
        lo, hi = iv
        if lo is None:
            return (ixe < P[hi]).astype(jnp.int32)
        if hi is None:
            return (ixe > P[lo]).astype(jnp.int32)
        return ((ixe > P[lo]) & (ixe < P[hi])).astype(jnp.int32)

    def event(intervals):
        if not intervals:
            return jnp.zeros(ixe.shape, jnp.int32)
        return functools.reduce(jnp.add, [ind(iv) for iv in intervals])

    q = jnp.full(ixe.shape, level_plan["base"], jnp.int32)
    for iv_list in level_plan["pos"]:
        q = q + event(iv_list)
    for iv_list in level_plan["neg"]:
        q = q - event(iv_list)
    return q, event(level_plan["hard"])


def _select_params(params_rows, mag_bits):
    """Per-element magnitude select: fold the rail's magnitude bits
    (first-transmitted first = MSB of m) over the nmag threshold rows.
    ``params_rows[m][j]`` scalar-like; returns list over j of selected
    arrays shaped like the bits."""
    nparam = len(params_rows[0])
    sel = []
    for j in range(nparam):
        entries = [params_rows[m][j] for m in range(len(params_rows))]
        for b in reversed(mag_bits):          # last bit = LSB of m
            entries = [jnp.where(b != 0, entries[2 * i + 1],
                                 entries[2 * i])
                       for i in range(len(entries) // 2)]
        sel.append(entries[0])
    return sel


def staircase_qam(ix_rail, sign_bit, mag_bits, params_rows, *,
                  mod_type, quant_bits, scale):
    """Shared QAM core: one int32 draw per rail -> per-level quantized
    LLRs and hard-decision indicators.

    ix_rail:  int32 [...], the rail's shared uniform draw (broadcast to
              every level position of the rail by the caller).
    sign_bit: the rail's transmitted sign bit (level-0 bit), any int.
    mag_bits: list of the rail's magnitude bits (levels 1..h-1, in
              transmit order = MSB of m first), each shaped like ix_rail.
    params_rows: [nmag][nparam] scalar-likes from _plan_threshold_ints.

    Returns (qs, hards): lists over level of int32 arrays; ``qs`` are
    final signed quantized LLRs (asymmetric clip applied), ``hards`` are
    {L_l > 0} indicators evaluated on the mirrored draw.  By the mirror
    identity hards[0] IS the level-0 ModCalErr indicator; for l >= 1 the
    caller XORs hards[l] with the transmitted bit."""
    levels, _ = _plan(mod_type, quant_bits, float(scale))
    lo, hi = _QUANT_LIMITS[quant_bits]
    mask0 = -(sign_bit != 0).astype(jnp.int32)
    ixe = ix_rail ^ mask0
    P = _select_params(params_rows, mag_bits)
    qs, hards = [], []
    for lev, lplan in enumerate(levels):
        q, h = _eval_level(ixe, lplan, P)
        if lev == 0:
            q = (q ^ mask0) - mask0        # sign restore (odd staircase)
        if -lo != hi:
            q = jnp.clip(q, lo, hi)
        qs.append(q)
        hards.append(h)
    return qs, hards


def _build_qam(code: QCCode, cfg) -> Callable:
    """16/64/256-QAM: one draw per I/Q rail, per-level staircases over
    the shared draw (exact joint law), magnitude-indexed threshold sets,
    evaluated on the interleaved bit order where a rail's bits are
    contiguous (CModulate.cpp:95-152)."""
    n = code.n_var
    mod = cfg.mod_type
    h = mod // 2
    nmag = 2 ** (h - 1)
    quant_bits = cfg.quant_bits
    scale = float(cfg.scale)
    depth = cfg.interleave_depth
    nparam = len(_plan(mod, quant_bits, scale)[1])

    def channel(cw, key, sigma):
        cwil = modem.interleave(cw, depth)
        b = cwil.shape[0]
        grp = cwil.reshape(b, n // mod, h, 2).astype(jnp.int32)
        bits = jax.random.bits(key, (b, n // mod, 2), jnp.uint32)
        ix = jax.lax.bitcast_convert_type(bits, jnp.int32)
        params = _plan_threshold_ints(cfg, sigma)
        rows = [[params[m, j] for j in range(nparam)] for m in range(nmag)]
        qs, hards = staircase_qam(ix, grp[:, :, 0, :],
                                  [grp[:, :, i, :] for i in range(1, h)],
                                  rows, mod_type=mod, quant_bits=quant_bits,
                                  scale=scale)
        errs = [hards[0]] + [hards[lev] ^ grp[:, :, lev, :]
                             for lev in range(1, h)]
        q = jnp.stack(qs, axis=2).reshape(b, n).astype(jnp.int8)
        err = jnp.stack(errs, axis=2).reshape(b, n).astype(jnp.int8)
        return modem.deinterleave(q, depth), modem.deinterleave(err, depth)

    return channel


def reduce_mod_stats(mod_err_map: jax.Array, n_info: int,
                     mod_type: int) -> tuple[jax.Array, jax.Array]:
    """ModCalErr map [batch, >= n_info] -> per-frame (info-bit errors
    [batch], info-symbol errors [batch]) int32.  Symbol = mod_type
    consecutive info bits (reference ModSER/ModBER denominators,
    main.cpp:183-188)."""
    batch = mod_err_map.shape[0]
    mod_err = mod_err_map[:, :n_info].astype(jnp.bool_)
    bits = mod_err.sum(axis=1).astype(jnp.int32)
    pad = (-n_info) % mod_type
    mod_err_p = jnp.pad(mod_err, ((0, 0), (0, pad)))
    sym_err = mod_err_p.reshape(
        batch, (n_info + pad) // mod_type, mod_type).any(axis=2)
    return bits, sym_err.sum(axis=1).astype(jnp.int32)


def build_fused_channel(code: QCCode, cfg) -> Callable:
    """Returns channel(cw_int8[batch, n], key, sigma) ->
    (llr int8[batch, n], mod_err int8[batch, n]), cw/llr/err in the
    pre-interleave (decoder) bit order.

    ``mod_err[i, j]`` is 1 where the pre-decoder hard decision differs
    from the transmitted bit (the ModCalErr indicator).  One threefry
    word per bit (BPSK/QPSK) or per I/Q rail (QAM)."""
    if not supports(cfg):
        raise ValueError("quantile channel unsupported for this config "
                         "(mod 1/2/4/6/8 + 2..6-bit quantizer only)")
    if cfg.mod_type in (4, 6, 8):
        return _build_qam(code, cfg)
    quant_bits = cfg.quant_bits

    def channel(cw, key, sigma):
        params = _threshold_ints(cfg, sigma)
        bits = jax.random.bits(key, cw.shape, jnp.uint32)
        ix = jax.lax.bitcast_convert_type(bits, jnp.int32)
        mask = -(cw != 0).astype(jnp.int32)
        return staircase(ix, mask, params, quant_bits)

    return channel
