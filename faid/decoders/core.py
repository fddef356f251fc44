"""Decoder assembly: LLR ingest -> layered MP iterations -> BF post-processor.

One function covers all six reference decode methods; the differences are
data (config + LUTs), not code paths:

  NMS        (reference CLDPC.cpp:214)            style=nms,  no early stop
  OMS        (CDecoder_OMS.cpp:13)                style=oms,  selective mode
  FAID+DTBF  (CDecoder_FAID.cpp:176)              style=faid, DTBF(10)
  OMS+BF     (CDecoder_OMSBF.cpp:12)              style=oms,  static BF(50)
  OMS+DTBF   (CDecoder_OMS_DTBF.cpp:17)           style=oms,  DTBF(50)
  FAID-2B1C  (CDecoder_FAID_2B1C.cpp:96)          style=faid, 2B1C-DTBF(10)

Early-stop semantics: the reference checks the syndrome at the top of each
iteration and breaks when all 32 SIMD lanes are clean.  Here every frame
is independent: a frame whose syndrome is clean at an iteration top is
frozen (no further updates), which is the group-size-1 limit of the
reference rule.  The MP loop is a ``lax.while_loop`` that exits as soon as
every frame in the batch is clean.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..code.qc_matrix import QCCode
from ..config import DecodeMethod, DecoderConfig
from ..ops import cn_update, fixed_point, syndrome as syn
from . import bf as bf_mod
from . import luts
from ..utils import vma

def _style_for(method: DecodeMethod) -> str:
    if method == DecodeMethod.NMS:
        return "nms"
    if method in (DecodeMethod.OMS, DecodeMethod.OMS_BF, DecodeMethod.OMS_DTBF):
        return "oms"
    return "faid"


group_any = bf_mod.group_any  # reference 32-frame-word OR (bf.py)


def ingest_llrs(llr: jnp.ndarray, code: QCCode) -> jnp.ndarray:
    """[batch, n_var] int8 -> block layout [batch, C, Z] with the code's
    punctured tail zeroed (reference CLDPC.cpp:270-272)."""
    if code.puncture_tail:
        llr = llr.at[:, llr.shape[1] - code.puncture_tail:].set(0)
    return llr.reshape(llr.shape[0], code.n_block_cols, code.z)


def build_decoder(code: QCCode, dcfg: DecoderConfig):
    """Returns decode(llr[batch, n_var] int8) ->
    dict(hard[batch, n_var] bool, mp_iters[batch], bf_rounds[batch]).

    Dense jnp/lax ops only, so one path serves every platform.  The BF
    post-processors are batch-masked while_loops that early-exit, not
    per-iteration sweeps.
    """
    style = _style_for(dcfg.method)
    if style == "nms" and (fixed_point.SAT_POS_MSG * dcfg.factor_1) >> 5 == 0:
        # The shared Profile default 1/6 floors the NMS normalization
        # (min*factor)>>5 to zero for every possible 4-bit min, pinning
        # FER at 1.0 (docs/VALIDATION.md).  NMS wants its own factors,
        # e.g. 26/32.
        import warnings

        warnings.warn(
            f"NMS normalization (min*{dcfg.factor_1})>>5 is zero for all "
            f"4-bit message magnitudes - every V2C message becomes 0 and "
            f"FER pins at 1.0. Use NMS-appropriate factors (e.g. 26/32).",
            stacklevel=2)
    needs_sweep = dcfg.stop_early
    needs_votes = style == "faid" and dcfg.ef_elimination == 2

    lut = lut_ef = None
    if style == "faid":
        lut = jnp.asarray(luts.table_for(dcfg.lut_family, dcfg.max_iter))
        if dcfg.ef_elimination >= 1:
            lut_ef = jnp.asarray(luts.ef_table(dcfg.max_iter))

    row_updates = [
        cn_update.make_block_row_update(
            code, r, style=style,
            factor_1=dcfg.factor_1, factor_2=dcfg.factor_2,
            oms_mode=dcfg.oms_mode, oms_offset=dcfg.oms_offset,
            lut=lut, lut_ef=lut_ef, sign_backtrack=dcfg.sign_backtrack,
            ef_elimination=dcfg.ef_elimination)
        for r in range(code.n_block_rows)
    ]
    entry_offsets = np.concatenate([[0], np.cumsum(code.degrees_np)])

    def one_iteration(it, en, msgs):
        """Full layered update of all block-rows; returns (en, msgs, active).

        The EF=2 erasure flags reset at the top of every iteration
        (reference CDecoder_FAID.cpp:624-628), so ``era`` is iteration-local.
        """
        if needs_sweep:
            unsat = syn.unsat_checks(syn.hard_decision(en), code)
            count = syn.error_count(unsat)
            active = count > 0
            l_m_err = count < dcfg.floor_err_count
            votes = syn.flip_votes(unsat, code) if needs_votes else None
        else:
            unsat = None
            active = jnp.ones((en.shape[0],), jnp.bool_)
            l_m_err = jnp.zeros((en.shape[0],), jnp.bool_)
            votes = None
        remaining = dcfg.max_iter - 1 - it
        in_floor = jnp.asarray(remaining <= dcfg.floor_iter_thresh)

        en_new, msgs_new = en, msgs
        if needs_votes:
            era_new = vma.pvary_like(
                jnp.zeros((en.shape[0], code.n_block_cols, code.z),
                          jnp.bool_), en)
        else:
            era_new = jnp.zeros((1,), jnp.bool_)
        for r in range(code.n_block_rows):
            lo, hi = int(entry_offsets[r]), int(entry_offsets[r + 1])
            ctx = cn_update.RowCtx(
                it=it, in_floor=in_floor,
                l_checksum=(unsat[:, r, :] if unsat is not None else None),
                l_m_error_sum=l_m_err, votes=votes, era=era_new)
            en_new, m_r, era_new = row_updates[r](en_new, msgs_new[:, lo:hi, :], ctx)
            msgs_new = msgs_new.at[:, lo:hi, :].set(m_r)

        # Freeze frames that were already clean at the iteration top.
        # stop_mode "group" reproduces the reference exactly: the break
        # happens only when a whole 32-frame SIMD word is clean, so a
        # clean frame keeps updating while any of its 32 group-mates is
        # dirty (CDecoder_OMS.cpp:325-327).  Groups are consecutive
        # 32-frame slices of the batch.
        if needs_sweep:
            if dcfg.stop_mode == "group":
                a3 = group_any(active)[:, None, None]
            else:
                a3 = active[:, None, None]
            en_new = jnp.where(a3, en_new, en)
            msgs_new = jnp.where(a3, msgs_new, msgs)
        return en_new, msgs_new, active

    n_entries = int(entry_offsets[-1])

    def decode(llr: jnp.ndarray):
        batch = llr.shape[0]
        en = ingest_llrs(llr, code)
        # Initial carries cast to `en`'s device-varying type so the
        # while_loop typechecks under shard_map (utils/vma.py).
        msgs = vma.pvary_like(
            jnp.zeros((batch, n_entries, code.z), jnp.int8), en)
        mp_iters = vma.batch_zeros(en, jnp.int32)

        def cond(carry):
            it, en, msgs, alive, mp_iters = carry
            return (it < dcfg.max_iter) & alive

        def body(carry):
            it, en, msgs, alive, mp_iters = carry
            en, msgs, active = one_iteration(it, en, msgs)
            # In group mode a clean frame keeps being updated while any
            # group-mate is dirty, so count the iteration for the whole
            # dirty group - the same granularity bf.py uses for
            # bf_rounds (a frame's count reflects work done on it).
            counted = (group_any(active) if dcfg.stop_mode == "group"
                       else active)
            mp_iters = mp_iters + counted.astype(jnp.int32)
            return it + 1, en, msgs, jnp.any(active), mp_iters

        carry = (jnp.int32(0), en, msgs,
                 vma.pvary_like(jnp.bool_(True), en), mp_iters)
        _, en, msgs, _, mp_iters = jax.lax.while_loop(cond, body, carry)

        hard = syn.hard_decision(en)
        bf_rounds = jnp.zeros((batch,), jnp.int32)
        kind = dcfg.bf.kind
        group = dcfg.stop_mode == "group"
        if kind == "static":
            hard, bf_rounds = bf_mod.run_static_bf(hard, code, dcfg.bf,
                                                   group=group)
        elif kind == "dtbf":
            hard, bf_rounds = bf_mod.run_dtbf(hard, code, dcfg.bf,
                                              group=group)
        elif kind == "dtbf2b1c":
            hard, bf_rounds = bf_mod.run_dtbf(hard, code, dcfg.bf,
                                              two_bit=True, llr=en,
                                              group=group)
        return {
            "hard": hard.reshape(batch, code.n_var),
            "mp_iters": mp_iters,
            "bf_rounds": bf_rounds,
        }

    return decode


def build_stats_decoder(code: QCCode, dcfg: DecoderConfig):
    """Counter-producing decoder for the Monte-Carlo hot path.

    Returns decode_stats(llr[batch, n_var] int8, ref_bits=None) ->
    dict(err_bits[batch] int32, mp_iters[batch], bf_rounds[batch]),
    where ``ref_bits`` is the expected info word [batch, n_info]
    (bool/int8) or None for the all-zero codeword (FakeEncoder).  The
    per-frame info-bit error count is CalculateErrors' core (reference
    CLDPC.cpp:4819-4995)."""
    dec = build_decoder(code, dcfg)
    n_info = code.n_info

    def decode_stats(llr: jnp.ndarray, ref_bits=None):
        out = dec(llr)
        hard = out["hard"][:, :n_info]
        err = (hard if ref_bits is None
               else jnp.logical_xor(hard, ref_bits.astype(jnp.bool_)))
        return {"err_bits": err.sum(axis=1).astype(jnp.int32),
                "mp_iters": out["mp_iters"],
                "bf_rounds": out["bf_rounds"]}

    return decode_stats
