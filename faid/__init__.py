"""faid - a batched Monte-Carlo FEC simulation framework for the
50G-PON LDPC code, with the capabilities of the reference CPU simulator
(Lcrypto/mod-interleaveavx_multithreads-FAID) re-designed for JAX/XLA.

Public API:
    load_code()                      the 50G-PON QC-LDPC code object
    SimConfig / DecoderConfig        typed configuration
    build_decoder(code, dcfg)        batched decoder (all six methods)
    MonteCarloRunner(cfg)            sharded SNR-sweep Monte-Carlo driver
"""

from .code.qc_matrix import QCCode, load_code
from .config import BFConfig, DecodeMethod, DecoderConfig, FaidLutFamily, SimConfig
from .decoders.core import build_decoder

__all__ = [
    "QCCode", "load_code",
    "BFConfig", "DecodeMethod", "DecoderConfig", "FaidLutFamily", "SimConfig",
    "build_decoder", "MonteCarloRunner",
]

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy: the runner pulls in the full sim stack, which the many users
    # who only need a decoder should not pay for at import time.
    if name == "MonteCarloRunner":
        from .sim.runner import MonteCarloRunner
        return MonteCarloRunner
    raise AttributeError(name)
