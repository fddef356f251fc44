"""Scalar numpy golden model - the test oracle for the JAX decoders.

This is a deliberate *re-derivation* of the reference algorithms over the
flat CN->VN edge list (the reference's own representation,
``PosNoeudsVariable``), processing one frame at a time with plain int32
arithmetic.  The JAX decoders use a completely different structure (dense
block rolls, batched, layered-per-block-row) - agreement between the two
validates both the circulant transformation and the fixed-point algebra.

Semantics notes (all against /root/reference):
  * CN walk is sequential and updates En in place -> layered schedule
    (CLDPC.cpp:276-406).  Rows within a Z-block touch disjoint VNs, so the
    JAX per-block-row batching is exact.
  * sign rule: LLR>0 => bit 1 convention gives
    sign(Lmn) = (-1)^deg * prod_{others} sign(Lnm), realized in the
    reference by the 0xC0/0x40 XOR constants (CLDPC.cpp:299-311).
  * early stop: syndrome at iteration top; the reference breaks per
    32-frame group - the golden model uses group size 1 (per-frame),
    matching the JAX freeze semantics.
"""

from __future__ import annotations

import numpy as np

from ..code.qc_matrix import QCCode
from ..config import BFConfig, DecoderConfig
from ..decoders import luts

SAT_POS_VAR, SAT_NEG_VAR = 31, -31
SAT_POS_MSG = 7


def _rows(code: QCCode):
    """Yield (row_slice, degree, odd) per CN in order."""
    edges = code.edge_list_np
    off = 0
    for r in range(code.n_block_rows):
        deg = code.degrees[r]
        for _ in range(code.z):
            yield edges[off:off + deg], deg, bool(deg & 1)
            off += deg


def _syndrome(code: QCCode, en: np.ndarray):
    """Returns (unsat[n_chk] bool, count, votes[n_var])."""
    hard = en > 0
    unsat = np.zeros(code.n_chk, dtype=bool)
    votes = np.zeros(code.n_var, dtype=np.int32)
    for cn, (row, deg, odd) in enumerate(_rows(code)):
        u = bool(np.bitwise_xor.reduce(hard[row]))
        unsat[cn] = u
        if u:
            votes[row] += 1
    return unsat, int(unsat.sum()), votes


def _min2(vals):
    m1 = m2 = SAT_POS_VAR
    for v in vals:
        m2 = min(m2, max(m1, v))
        m1 = min(v, m1)
    return m1, m2


def decode_golden(llr: np.ndarray, code: QCCode, dcfg: DecoderConfig):
    """Decode one frame. llr: [n_var] int8-valued ints.
    Returns dict(hard bits uint8 [n_var], mp_iters, bf_rounds)."""
    style = ("nms" if dcfg.method.value == 0
             else "oms" if dcfg.method.value in (1, 3, 4) else "faid")
    en = llr.astype(np.int32).copy()
    if code.puncture_tail:
        en[code.n_var - code.puncture_tail:] = 0
    msgs = np.zeros(code.n_edges, dtype=np.int32)
    vn_weight = code.vn_weight_np

    if style == "faid":
        lut = luts.table_for(dcfg.lut_family, dcfg.max_iter).astype(np.int32)
        lut_ef = luts.ef_table(dcfg.max_iter).astype(np.int32)

    mp_iters = 0
    for it in range(dcfg.max_iter):
        if dcfg.stop_early:
            unsat, count, votes = _syndrome(code, en)
            if count == 0:
                break
            l_m_err = count < dcfg.floor_err_count
        else:
            unsat = np.zeros(code.n_chk, dtype=bool)
            l_m_err = False
            votes = np.zeros(code.n_var, dtype=np.int32)
        mp_iters += 1
        remaining = dcfg.max_iter - 1 - it
        in_floor = remaining <= dcfg.floor_iter_thresh
        era = np.zeros(code.n_var, dtype=bool)

        off = 0
        for cn, (row, deg, odd) in enumerate(_rows(code)):
            sl = slice(off, off + deg)
            off += deg
            vc = np.maximum(
                np.clip(en[row] - msgs[sl], -128, 127), SAT_NEG_VAR)
            if style == "faid":
                vc = np.minimum(vc, SAT_POS_VAR)
                if dcfg.ef_elimination == 2 and in_floor:
                    for j in range(deg):
                        v = row[j]
                        if (vn_weight[v] == 3 and votes[v] >= 3
                                and l_m_err and not era[v]):
                            vc[j] = 0
                            era[v] = True
                if dcfg.sign_backtrack:
                    neg = np.where(vc == 0, en[row], vc) < 0
                else:
                    neg = vc < 0
            else:
                neg = vc < 0
            parity = bool(np.bitwise_xor.reduce(neg))

            if style == "faid":
                idx = np.minimum(np.abs(vc), 7)
                mag = lut[it][idx]
                if dcfg.ef_elimination >= 1 and in_floor and l_m_err and unsat[cn]:
                    mag = lut_ef[it][idx]
            elif style == "oms":
                mag = np.minimum(np.abs(vc), SAT_POS_MSG)
            else:
                mag = np.abs(vc)
            min1, min2 = _min2(mag.tolist())

            if style == "nms":
                c2 = min(np.clip((min1 * dcfg.factor_1) >> 5, -128, 127),
                         SAT_POS_MSG)
                c1 = min(np.clip((min2 * dcfg.factor_2) >> 5, -128, 127),
                         SAT_POS_MSG)
            elif style == "faid" or dcfg.oms_mode == 0:
                c1 = min(min2 - dcfg.oms_offset, SAT_POS_MSG)
                c2 = min(min1 - dcfg.oms_offset, SAT_POS_MSG)
            else:  # selective OMS
                def offsel(m):
                    if in_floor and unsat[cn] and l_m_err:
                        m = m + (1 if m < dcfg.factor_2 else 0)
                        m = m + (1 if m <= dcfg.factor_1 else 0)
                    else:
                        m = m - (1 if m > dcfg.factor_1 else 0)
                        m = m - (1 if m >= dcfg.factor_2 else 0)
                    return m
                c1 = min(offsel(min2), SAT_POS_MSG)
                c2 = min(offsel(min1), SAT_POS_MSG)

            cmp_val = mag if style == "faid" else np.abs(vc)
            for j in range(deg):
                vres = c1 if cmp_val[j] == min1 else c2
                n = parity ^ bool(neg[j]) ^ odd
                new_msg = -vres if n else vres
                msgs[off - deg + j] = new_msg
                en[row[j]] = min(max(np.clip(vc[j] + new_msg, -128, 127),
                                     SAT_NEG_VAR), SAT_POS_VAR)

    hard = en > 0
    bf_rounds = 0
    cfg = dcfg.bf
    if cfg.kind == "static":
        hard, bf_rounds = _static_bf(hard, code, cfg)
    elif cfg.kind == "dtbf":
        hard, bf_rounds = _dtbf(hard, code, cfg, two_bit=False, llr=en)
    elif cfg.kind == "dtbf2b1c":
        hard, bf_rounds = _dtbf(hard, code, cfg, two_bit=True, llr=en)
    return {"hard": hard.astype(np.uint8), "mp_iters": mp_iters,
            "bf_rounds": bf_rounds}


def _syndrome_hard(code: QCCode, hard: np.ndarray):
    unsat = np.zeros(code.n_chk, dtype=bool)
    votes = np.zeros(code.n_var, dtype=np.int32)
    for cn, (row, deg, odd) in enumerate(_rows(code)):
        u = bool(np.bitwise_xor.reduce(hard[row]))
        unsat[cn] = u
        if u:
            votes[row] += 1
    return unsat, int(unsat.sum()), votes


def _static_bf(hard, code: QCCode, cfg: BFConfig):
    rounds = 0
    for _ in range(cfg.max_iter):
        unsat, count, votes = _syndrome_hard(code, hard)
        if count == 0:
            break
        max_vote = max(int(votes.max()), 1)
        thresh = min(max_vote, cfg.static_vote_cap)
        hard = hard ^ (votes >= thresh)
        rounds += 1
    return hard, rounds


def _dtbf(hard, code: QCCode, cfg: BFConfig, two_bit: bool, llr):
    hard = hard.copy()
    hard_ch = hard.copy()
    vn_weight = code.vn_weight_np
    eligible = vn_weight == cfg.gamma
    if two_bit:
        hard2 = (llr >= cfg.reliability_threshold) | (llr <= -cfg.reliability_threshold)
    else:
        hard2 = np.zeros_like(hard)
    Th, l0, l1, t = cfg.gamma, 0, 0, True
    rounds = 0
    for _ in range(cfg.max_iter):
        unsat, count, votes = _syndrome_hard(code, hard)
        if count == 0:
            break
        rounds += 1
        if not t:
            Th -= cfg.delta
        if t and l0 < cfg.l0:
            Th = cfg.gamma + cfg.alpha
            l0 += 1
        elif t and l1 < cfg.l1:
            Th = cfg.gamma + cfg.alpha - cfg.delta
            l1 += 1
        elif t:
            Th = cfg.gamma + cfg.alpha - 2 * cfg.delta
        Th = max(Th, 1)

        score = votes + cfg.alpha * (hard ^ hard_ch)
        flip = eligible & (score >= Th)
        t = bool(flip.any())
        if two_bit:
            if Th >= cfg.gamma:  # big jump: flip both bits
                hard = hard ^ flip
                hard2 = hard2 ^ flip
            else:                # small jump: demote or flip
                hard = hard ^ (flip & ~hard2)
                hard2 = hard2 ^ (flip & hard2)
        else:
            hard = hard ^ flip
    return hard, rounds
