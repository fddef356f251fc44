"""Histograms, forensic error-frame replay, and iterCount reporting."""

import numpy as np
import jax
import jax.numpy as jnp

from faid.code.toy import toy_code
from faid.config import DecodeMethod, SimConfig
from faid.sim.pipeline import build_debug_step, build_sim_step
from faid.sim.runner import MonteCarloRunner


def cfg_at(**kw):
    base = dict(decode_method=DecodeMethod.FAID_DTBF, max_iteration=2,
                mod_type=2, batch_per_device=4, seed=3, fake_encode=True,
                min_frames=8, min_frame_errors=0, rounds_per_sync=2)
    base.update(kw)
    return SimConfig(**base)


def test_histograms_sum_to_frames():
    code = toy_code()
    cfg = cfg_at()
    step = jax.jit(build_sim_step(code, cfg))
    out = jax.tree.map(np.asarray,
                       step(jax.random.key(0), jnp.float32(cfg.sigma_at(2.0))))
    assert out["mp_hist"].sum() == out["test_frames"]
    assert out["bf_hist"].sum() == out["test_frames"]
    # mp_iters total must equal the histogram-weighted sum
    assert (out["mp_hist"] * np.arange(len(out["mp_hist"]))).sum() \
        == out["mp_iters"]


def test_debug_step_matches_sim_step_counts():
    """The forensic replay must reproduce the exact error counts of the
    hot-path step for the same key."""
    code = toy_code()
    cfg = cfg_at()
    step = jax.jit(build_sim_step(code, cfg))
    debug = jax.jit(build_debug_step(code, cfg))
    key = jax.random.key(7)
    sigma = jnp.float32(cfg.sigma_at(-3.0))  # noisy: guaranteed errors
    a = jax.tree.map(np.asarray, step(key, sigma))
    b = jax.tree.map(np.asarray, debug(key, sigma))
    assert a["error_bits"] == int(b["err_bits"].sum())
    assert a["error_frames"] == int((b["err_bits"] > 0).sum())


def test_runner_forensics_and_itercount(tmp_path):
    code = toy_code()
    cfg = cfg_at(snr_start=-3.0, snr_pass=1.0, snr_end=-2.0,
                 min_frames=8)
    r = MonteCarloRunner(cfg, code=code, max_rounds_per_snr=4)
    r.run()
    assert r.results[0].err_chunks, "low SNR must produce error chunks"
    r.write_itercount_txt(tmp_path / "iterCount.txt")
    txt = (tmp_path / "iterCount.txt").read_text()
    assert "mp_iters" in txt and "bf_rounds" in txt

    n = r.collect_error_frames(tmp_path, max_frames=16)
    assert n > 0
    idx = (tmp_path / "errorindex.txt").read_text()
    assert "frame" in idx and "b" in idx
    # every dumped line names at least one block+offset
    first = idx.splitlines()[0]
    assert " : b" in first
    # counted errors in the dump are consistent with the runner counters
    total_err_frames = r.results[0].counters["error_frames"]
    assert n <= max(total_err_frames, 16)


def test_temp_txt_live_progress(tmp_path):
    """Temp.txt is rewritten per sync with the in-flight point's row
    (reference main.cpp:194-207: columns + the assume-one-is-wrong
    FER/BER floor) and the exact-resume state."""
    code = toy_code()
    cfg = cfg_at(snr_start=-3.0, snr_pass=1.0, snr_end=-2.5,
                 min_frames=8)
    r = MonteCarloRunner(cfg, code=code, max_rounds_per_snr=4,
                         temp_txt_path=tmp_path / "Temp.txt")
    r.run()
    txt = (tmp_path / "Temp.txt").read_text()
    row, resume = txt.splitlines()[:2]
    cols = row.split("\t")
    assert len(cols) >= 7
    assert int(cols[1]) == r.results[-1].counters["test_frames"]
    assert float(cols[4]) > 0          # FER floor: never 0
    assert "resume: seed=" in resume and "checkpoint.json" in resume


def test_errorfloat_dump(tmp_path):
    """collect_error_frames must also dump the pre-quantizer float LLRs
    (the reference's errorfloat.txt, CLDPC.cpp:4877-4991)."""
    code = toy_code()
    cfg = cfg_at(snr_start=-3.0, snr_pass=1.0, snr_end=-2.0, min_frames=8)
    r = MonteCarloRunner(cfg, code=code, max_rounds_per_snr=4)
    r.run()
    n = r.collect_error_frames(tmp_path, max_frames=8)
    assert n > 0
    flt = (tmp_path / "errorfloat.txt").read_text().splitlines()
    llr = (tmp_path / "errorllr.txt").read_text().splitlines()
    assert len(flt) == len(llr) == n
    # float lines carry one float per erroneous position, and each float
    # quantizes to the dumped 4-bit LLR
    import numpy as np
    from faid.ops.fixed_point import quantize_llr
    for fl, ql in zip(flt, llr):
        fvals = np.array([float(x) for x in fl.split(" : ")[1].split()],
                         np.float32)
        qvals = np.array([int(x) for x in ql.split(" : ")[1].split()])
        got = np.asarray(quantize_llr(fvals, cfg.scale, cfg.quant_bits))
        # dumped floats are rounded to 6 decimals; allow boundary slips
        assert (got == qvals).mean() > 0.9


def test_checkpoint_config_fingerprint(tmp_path):
    """Resuming under a changed config must start fresh, not merge
    incompatible state (ADVICE round 1)."""
    import dataclasses
    import warnings

    code = toy_code()
    cfg = cfg_at(snr_start=-3.0, snr_pass=1.0, snr_end=-1.0, min_frames=8)
    ck = tmp_path / "ck.json"
    r1 = MonteCarloRunner(cfg, code=code, checkpoint_path=ck,
                          max_rounds_per_snr=2)
    r1.run_snr(0, -3.0)
    r1._save_checkpoint()
    assert ck.exists()

    cfg2 = dataclasses.replace(cfg, max_iteration=3)  # different histograms
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        r2 = MonteCarloRunner(cfg2, code=code, checkpoint_path=ck,
                              max_rounds_per_snr=2)
    assert any("fingerprint" in str(x.message) for x in w)
    assert r2._state["snr_idx"] == 0
    assert r2._state["round"] == 0

    # same config resumes normally
    r3 = MonteCarloRunner(cfg, code=code, checkpoint_path=ck,
                          max_rounds_per_snr=2)
    assert r3._state["round"] > 0

    # result-neutral changes (stopping rule, sync cadence) must NOT
    # invalidate the checkpoint: deepening a sweep keeps accumulated
    # statistics.
    cfg4 = dataclasses.replace(cfg, min_frame_errors=999, rounds_per_sync=3)
    r4 = MonteCarloRunner(cfg4, code=code, checkpoint_path=ck,
                          max_rounds_per_snr=2)
    assert r4._state["round"] > 0


def test_checkpoint_from_before_backend_removal_resumes(tmp_path):
    """SimConfig once had a result-neutral ``backend`` field that the
    fingerprint skipped; a checkpoint written then (fingerprint recorded
    from that code) must still resume."""
    import json

    from faid.sim.runner import COUNTER_KEYS, config_fingerprint

    cfg = cfg_at(snr_start=-3.0, snr_pass=1.0, snr_end=-1.0, min_frames=8)
    old_fp = "158b177729b24267"
    assert config_fingerprint(cfg) == old_fp
    counters = {k: 0 for k in COUNTER_KEYS}
    counters.update(test_frames=16, mp_hist=[16, 0, 0], bf_hist=[16] + [0] * 10)
    ck = tmp_path / "checkpoint.json"
    ck.write_text(json.dumps({
        "seed": cfg.seed, "config_fingerprint": old_fp,
        "state": {"snr_idx": 1, "round": 4, "counters": counters,
                  "err_chunks": [], "done": []},
        "results": [{"snr_db": -3.0, "counters": counters, "seconds": 1.0,
                     "err_chunks": []}]}))
    r = MonteCarloRunner(cfg, code=toy_code(), checkpoint_path=ck,
                         max_rounds_per_snr=2)
    assert r._state["snr_idx"] == 1 and r._state["round"] == 4
    assert r.results[0].counters["test_frames"] == 16


def test_sweep_economics_budget(tmp_path):
    """max_frames_per_snr and giveup_zero_error_frames bound the work a
    deep-floor (zero-error) point can burn."""
    code = toy_code()
    # high SNR -> zero errors; min_frame_errors=1 would loop to
    # max_rounds without the give-up rule
    cfg = cfg_at(snr_start=20.0, snr_pass=1.0, snr_end=21.0,
                 min_frames=8, min_frame_errors=1,
                 giveup_zero_error_frames=16)
    r = MonteCarloRunner(cfg, code=code, max_rounds_per_snr=1000)
    res = r.run()
    # One sync = batch_per_device * n_devices * rounds_per_sync frames;
    # the budget check stops after the first sync crosses the threshold.
    per_sync = 4 * len(__import__("jax").devices()) * 2
    assert res[0].counters["error_frames"] == 0
    assert res[0].counters["test_frames"] <= per_sync  # stopped early

    cfg2 = cfg_at(snr_start=-3.0, snr_pass=1.0, snr_end=-2.0,
                  min_frames=8, min_frame_errors=10**9,
                  max_frames_per_snr=16)
    r2 = MonteCarloRunner(cfg2, code=code, max_rounds_per_snr=1000)
    res2 = r2.run()
    assert res2[0].counters["test_frames"] <= per_sync
