"""Config semantics: sigma formula, per-method decoder configs."""

import math

from faid.config import BFConfig, DecodeMethod, DecoderConfig, SimConfig


def test_sigma_formula_qpsk():
    # sigma = 1/sqrt(R * modtype * 10^(SNR/10)) (reference CSimulate.cpp:70-91)
    cfg = SimConfig(mod_type=2)
    snr = 4.0
    expect = 1.0 / math.sqrt(cfg.rate * 2 * 10 ** 0.4)
    assert abs(cfg.sigma_at(snr) - expect) < 1e-9


def test_sigma_formula_bpsk_extra_factor_2():
    # BPSK has the extra factor 2 inside the sqrt (CSimulate.cpp:70-74).
    cfg = SimConfig(mod_type=1)
    expect = 1.0 / math.sqrt(2.0 * cfg.rate * 1 * 10 ** 0.4)
    assert abs(cfg.sigma_at(4.0) - expect) < 1e-9


def test_rate_is_reference_value():
    assert abs(SimConfig().rate - 0.8444444) < 1e-6
    assert abs(14592 / 17280 - 0.8444444) < 1e-6


def test_per_method_configs_match_reference_defines():
    d = DecoderConfig.for_method
    assert d(DecodeMethod.NMS).stop_early is False
    assert d(DecodeMethod.OMS).oms_mode == 1
    assert d(DecodeMethod.FAID_DTBF).bf == BFConfig(
        kind="dtbf", max_iter=10, delta=1, l0=50, l1=0, alpha=1)
    assert d(DecodeMethod.OMS_BF).bf.kind == "static"
    assert d(DecodeMethod.OMS_BF).bf.max_iter == 50
    assert d(DecodeMethod.OMS_DTBF).bf.l0 == 0
    assert d(DecodeMethod.OMS_DTBF).bf.l1 == 50
    assert d(DecodeMethod.FAID_2B1C).bf.kind == "dtbf2b1c"
    assert d(DecodeMethod.FAID_2B1C).ef_elimination == 1


def test_configs_hashable():
    # jit-static requirement
    hash(SimConfig())
    hash(DecoderConfig.for_method(DecodeMethod.FAID_DTBF))


def test_lut_family_plumbing():
    from faid.config import FaidLutFamily

    cfg = SimConfig(decode_method=DecodeMethod.FAID_DTBF, faid_lut="faid32")
    assert cfg.decoder().lut_family == FaidLutFamily.FAID32
    # non-FAID methods ignore the override
    cfg2 = SimConfig(decode_method=DecodeMethod.OMS, faid_lut="faid2")
    assert cfg2.decoder().method == DecodeMethod.OMS
    # 2B1C keeps its own tables
    cfg3 = SimConfig(decode_method=DecodeMethod.FAID_2B1C, faid_lut="faid2")
    assert cfg3.decoder().lut_family == FaidLutFamily.FAID_2B1C
