"""Modulation / demodulation / channel interleaving, batched over frames.

Reproduces reference CModulate.cpp: Gray-mapped BPSK/QPSK/16/64/256-QAM
amplitude tables (CModulate.cpp:4-7), bit->symbol packing
(Modulation, :216-264), the max-log-MAP "folding" soft demap
(Demodulation, :270-362) and the per-frame depth-D block interleaver
(BeforeModulationInterleaver :95-152 / AfterDeModulationDeInterleaver
:156-212).

The reference shuffles between frame-major and SIMD-interleaved byte
layouts around these steps (uchar_transpose_avx); here frames are simply
rows of a [batch, n] tensor so those corner-turns do not exist.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# Gray-map amplitude tables, reference CModulate.cpp:4-7.
TABLE_QPSK = np.array([-0.707107, 0.707107], np.float32)
TABLE_16QAM = np.array([-0.316228, -0.948683, 0.316228, 0.948683], np.float32)
TABLE_64QAM = np.array(
    [-0.462910, -0.154303, -0.771517, -1.08012,
     0.462910, 0.154303, 0.771517, 1.08012], np.float32)
TABLE_256QAM = np.array(
    [-0.383482, -0.536875, -0.230089, -0.076696,
     -0.843661, -0.690268, -0.997054, -1.150447,
     0.383482, 0.536875, 0.230089, 0.076696,
     0.843661, 0.690268, 0.997054, 1.150447], np.float32)

_TABLES = {2: TABLE_QPSK, 4: TABLE_16QAM, 6: TABLE_64QAM, 8: TABLE_256QAM}

# Max-log demap folding constants, reference CModulate.cpp:290-353.
# Kept as Python floats (doubles): the reference subtracts the *double*
# literal from a float and narrows the result to float
# (`fabs(x) - 0.6324555`, CModulate.cpp:291) - see _fold_sub.
_FOLD = {
    2: [],
    4: [0.6324555],
    6: [0.6172134, 0.3086067],
    8: [0.613568, 0.306784, 0.153392],
}


def _fold_sub(x: jnp.ndarray, const: float) -> jnp.ndarray:
    """float32(float64(x) - const) computed entirely in float32.

    The reference's fold step is `fabs(x) - <double literal>` narrowed
    to float on store (CModulate.cpp:270-362).  A plain float32 subtract
    of the rounded constant differs in the last ULP ~50% of the time,
    which flips a 4-bit quantizer output about 2e-6 of the time - enough
    to break bit-exactness against the reference binary.  Split the
    constant into hi+lo float32 parts and compensate the subtraction
    (TwoSum), which reproduces the double-narrowed result exactly
    (0 mismatches over 6x10M boundary-dense samples; gated by
    tests/test_refbinary.py::test_modem_parity)."""
    c_hi = np.float32(const)
    c_lo = np.float32(const - float(c_hi))
    b = jnp.float32(-c_hi)
    s = x + b
    bb = s - x
    err = (x - (s - bb)) + (b - bb)
    return s + (err - jnp.float32(c_lo))


def interleave(bits: jnp.ndarray, depth: int) -> jnp.ndarray:
    """Per-frame block interleaver: out[k] = in[(L/D)*i + j] for
    j in [0, L/D), i in [0, D)  (reference CModulate.cpp:138-149).
    bits: [batch, L]."""
    if depth == 1:
        return bits
    b, length = bits.shape
    return bits.reshape(b, depth, length // depth).transpose(0, 2, 1).reshape(b, length)


def deinterleave(llr: jnp.ndarray, depth: int) -> jnp.ndarray:
    """Inverse of interleave (reference CModulate.cpp:161-171)."""
    if depth == 1:
        return llr
    b, length = llr.shape
    return llr.reshape(b, length // depth, depth).transpose(0, 2, 1).reshape(b, length)


def modulate_bpsk(bits: jnp.ndarray) -> jnp.ndarray:
    """bit -> 2b-1 amplitude (reference CModulate.cpp:363-370)."""
    return (2 * bits - 1).astype(jnp.float32)


def modulate_qam(bits: jnp.ndarray, mod_type: int) -> jnp.ndarray:
    """bits [batch, L] -> complex symbols as (i, q) floats
    [batch, L/mod_type, 2].  Even bit positions feed I, odd feed Q; within
    each rail the first bit is the MSB (reference CModulate.cpp:244-262).

    The amplitude lookup is a select tree over the bits rather than a
    ``table[idx]`` gather: a tree of ``2**half - 1`` elementwise selects
    produces float-identical amplitudes and fuses with the neighbouring
    elementwise ops."""
    table = _TABLES[mod_type]
    half = mod_type // 2
    b, length = bits.shape
    grp = bits.reshape(b, length // mod_type, half, 2)  # [..., j, (I,Q)]
    # Fold in bits LSB-first: each level halves the candidate table by
    # selecting between entries whose index differs in that bit.
    entries = [jnp.float32(v) for v in table]
    for k in range(half - 1, -1, -1):
        bit = grp[:, :, k, :] != 0
        entries = [jnp.where(bit, entries[2 * i + 1], entries[2 * i])
                   for i in range(len(entries) // 2)]
    return entries[0]


def demodulate_qam(sym: jnp.ndarray, mod_type: int) -> jnp.ndarray:
    """Max-log soft demap: b0/b1 are I/Q, higher bits fold
    |prev| - const (reference CModulate.cpp:270-362).
    sym [batch, nsym, 2] -> llrs [batch, nsym*mod_type]."""
    outs = [sym]  # level 0: (I, Q)
    prev = sym
    for const in _FOLD[mod_type]:
        prev = _fold_sub(jnp.abs(prev), const)
        outs.append(prev)
    # Stack level-major then interleave: output order per symbol is
    # [I0, Q0, I1, Q1, ...] matching DemodSeq layout.
    stacked = jnp.stack(outs, axis=2)  # [batch, nsym, levels, 2]
    b, nsym = sym.shape[0], sym.shape[1]
    return stacked.reshape(b, nsym * mod_type)


def demodulate_bpsk(sym: jnp.ndarray) -> jnp.ndarray:
    return sym
