"""Toy-code construction, multi-chip dry run, and Profile.txt parsing."""

import numpy as np
import jax

from faid.code import encoder as enc
from faid.code.toy import toy_code
from faid.config import DecodeMethod, SimConfig
from faid.utils.profile import parse_profile, write_profile


def test_toy_code_structure():
    code = toy_code()
    assert code.n_var == 96 and code.n_chk == 32
    assert code.vn_weight_np.min() >= 1
    assert (code.vn_weight_np == 3).sum() > 0  # DTBF-eligible columns


def test_toy_encoder_roundtrip(rng):
    import jax.numpy as jnp
    code = toy_code()
    encode = enc.make_encode_fn(code)
    u = rng.integers(0, 2, size=(8, code.n_info)).astype(np.int8)
    c = np.asarray(encode(jnp.asarray(u)))
    assert (enc.syndrome_weight_np(code, c) == 0).all()


def test_dryrun_multichip_8():
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import __graft_entry__ as g
    g.dryrun_multichip(8)
    g.dryrun_multichip(4)


def test_profile_roundtrip(tmp_path):
    cfg = SimConfig(snr_start=2.5, snr_pass=0.25, snr_end=4.0,
                    decode_method=DecodeMethod.OMS_DTBF, max_iteration=8,
                    mod_type=4, interleave_depth=2, factor_1=2, factor_2=5,
                    scale=12.5)
    p = tmp_path / "Profile.txt"
    write_profile(cfg, p)
    got = parse_profile(p)
    for f in ("snr_start", "snr_pass", "snr_end", "decode_method",
              "max_iteration", "mod_type", "interleave_depth",
              "factor_1", "factor_2", "scale"):
        assert getattr(got, f) == getattr(cfg, f), f


def test_parse_reference_profile_format(tmp_path):
    """Parse a byte-for-byte copy of the reference's Profile.txt layout."""
    text = """Simulation parameter
StartSNR: 3
SNRPass: 0.1
EndSNR: 5
DecodeMethod: 2
MaxIteration: 6
Modulation Parameter:
modType: 2
InterleaveModType: 1
NMS  Factor:
Factor_1: 1
Factor_2: 6
noFrames: 32
scale: 13
Matrix Factor
FileName: 50GPON-CP12
Z: 256
"""
    p = tmp_path / "Profile.txt"
    p.write_text(text)
    cfg = parse_profile(p)
    assert cfg.snr_start == 3.0 and cfg.snr_pass == 0.1 and cfg.snr_end == 5.0
    assert cfg.decode_method == DecodeMethod.FAID_DTBF
    assert cfg.max_iteration == 6 and cfg.mod_type == 2
    assert cfg.scale == 13.0 and cfg.z == 256
    assert cfg.file_name_key() == "50gpon"
