"""Regression guard: the decoder compile must not trip XLA's algebraic
simplifier circular-loop breaker.

Rounds 1-4 compiled the DTBF while body into a graph where the flip
mask reads the hard decisions both directly (the disagree term) and
through the rolled syndrome/vote chain; XLA's concatenate-splitting and
xor-cancellation rewrites ping-pong on it and every compile emitted
five "Algebraic simplifier is likely stuck in a circular simplification
loop and ran for 50 runs" errors (MULTICHIP_r04.json tail).  Fixed by
an optimization_barrier on the materialized vote tensor
(decoders/bf.py); this test pins the fix by compiling the previously
offending config in a subprocess and scanning its stderr (the warning
comes from XLA's C++ logging, which pytest cannot capture in-process).
"""

import subprocess
import sys

_CHILD = """
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp, numpy as np
from faid.code.qc_matrix import load_code
from faid.config import DecodeMethod, DecoderConfig
from faid.decoders.core import build_decoder
code = load_code("50gpon")
dcfg = DecoderConfig.for_method(DecodeMethod.FAID_DTBF, max_iter=2)
dec = jax.jit(build_decoder(code, dcfg))
rng = np.random.default_rng(0)
llr = jnp.asarray(rng.integers(-7, 8, (8, code.n_var)).astype(np.int8))
jax.device_get(dec(llr)["mp_iters"])
print("COMPILED_OK")
"""


def test_faid_dtbf_compile_has_no_simplifier_loop():
    r = subprocess.run([sys.executable, "-c", _CHILD],
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "COMPILED_OK" in r.stdout
    assert "circular simplification" not in r.stderr, (
        "XLA algebraic simplifier loop-breaker fired:\n" + r.stderr[-2000:])
