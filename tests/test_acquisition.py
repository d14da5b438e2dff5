"""Acquisition engine tests on synthetic IF scenes (ground truth known)."""

import numpy as np
import pytest

from cusdr_tpu import get_config
from cusdr_tpu.signals.defs import get_signal
from cusdr_tpu.io.synth import SynthSV, synthesize_if
from cusdr_tpu.acquisition import acquire

# Small but realistic scenario: 4.092 MHz fs keeps CPU FFTs cheap
CFG = dict(sampling_freq=4.092e6, if_freq=9.548e3,
           acq_satellite_list=tuple(range(1, 17)), acq_non_coh_time=10)

TRUTH = [
    SynthSV(prn=7, code_phase=1234.0, doppler_hz=2500.0, cn0_dbhz=45),
    SynthSV(prn=13, code_phase=100.2, doppler_hz=-3200.0, cn0_dbhz=43),
    SynthSV(prn=3, code_phase=4000.0, doppler_hz=450.0, cn0_dbhz=48),
]


@pytest.fixture(scope="module")
def scene():
    cfg = get_config("gps_l1ca", **CFG)
    sig = get_signal("gps_l1ca")
    samples = synthesize_if(cfg, sig, TRUTH, num_ms=60, seed=3)
    return cfg, sig, acquire(cfg, sig, samples)


def test_detects_all_present_prns(scene):
    cfg, sig, res = scene
    present = {sv.prn for sv in TRUTH}
    detected = {int(p) for i, p in enumerate(res.prns) if res.detected[i]}
    assert present <= detected


def test_no_false_alarms(scene):
    cfg, sig, res = scene
    present = {sv.prn for sv in TRUTH}
    false = {int(p) for i, p in enumerate(res.prns)
             if res.detected[i]} - present
    assert not false


def test_code_phase_exact(scene):
    """Peak must land on the true code-start sample (±1 for fractional)."""
    cfg, sig, res = scene
    spc = cfg.samples_per_code
    for sv in TRUTH:
        i = list(res.prns).index(sv.prn)
        err = (int(res.code_phase[i]) - sv.code_phase) % spc
        err = min(err, spc - err)
        assert err <= 1.5, (sv.prn, res.code_phase[i], sv.code_phase)


def test_fine_freq_within_step(scene):
    """Fine carrier frequency within one fine-search step of truth
    (acquisition.m:203-260: 25 Hz default)."""
    cfg, sig, res = scene
    for sv in TRUTH:
        i = list(res.prns).index(sv.prn)
        truth = cfg.if_freq + sv.doppler_hz
        assert abs(res.carr_freq[i] - truth) <= cfg.fine_search_step, \
            (sv.prn, res.carr_freq[i], truth)


def test_best_channels_ordering(scene):
    """preRun semantics: channels sorted by peak metric descending
    (preRun.m:60-72)."""
    cfg, sig, res = scene
    best = res.best_channels(12)
    assert len(best) >= 3
    metrics = [res.peak_metric[list(res.prns).index(p)]
               for p, *_ in best]
    assert metrics == sorted(metrics, reverse=True)
    # strongest SV (48 dB-Hz) first
    assert best[0][0] == 3


def test_circshift_matches_brute_force(scene):
    """The circular-shift frequency search (one signal FFT, Doppler via
    spectrum rotation — GPS_L2C/include/acquisition.m:25,71-84) must find
    the same SVs at the same code phases, with carrier frequency within
    the fine step, as the per-bin PCPS grid."""
    cfg, sig, res = scene
    samples = synthesize_if(cfg, sig, TRUTH, num_ms=60, seed=3)
    res_c = acquire(cfg.replace(acq_method="circshift"), sig, samples)
    for sv in TRUTH:
        i = list(res.prns).index(sv.prn)
        assert res_c.detected[i]
        assert int(res_c.code_phase[i]) == int(res.code_phase[i])
        assert abs(res_c.carr_freq[i] - (cfg.if_freq + sv.doppler_hz)) \
            <= cfg.fine_search_step
    present = {sv.prn for sv in TRUTH}
    false = {int(p) for i, p in enumerate(res_c.prns)
             if res_c.detected[i]} - present
    assert not false


def test_coherent_blocks():
    """acq_coh_time > one code period tiles the replica for longer
    coherent integration; a weak SV on a fine grid gains metric vs the
    1-ms baseline (coherent SNR gain)."""
    cfg = get_config("gps_l1ca", sampling_freq=4.092e6, if_freq=9.548e3,
                     acq_satellite_list=(5, 9), acq_non_coh_time=4,
                     acq_search_step=100.0)   # step < 1/(2*T_coh)
    sig = get_signal("gps_l1ca")
    sv = SynthSV(prn=9, code_phase=2500.0, doppler_hz=1150.0,
                 cn0_dbhz=38)
    samples = synthesize_if(cfg, sig, [sv], num_ms=60, seed=11)
    res1 = acquire(cfg, sig, samples)
    res4 = acquire(cfg.replace(acq_coh_time=4, acq_non_coh_time=1),
                   sig, samples)
    i = list(res4.prns).index(9)
    assert res4.detected[i]
    spc = cfg.samples_per_code
    err = (int(res4.code_phase[i]) - 2500) % spc
    assert min(err, spc - err) <= 1.5
    assert abs(res4.carr_freq[i] - (cfg.if_freq + 1150.0)) \
        <= cfg.fine_search_step
    # coherent gain: metric improves over the same total data
    assert res4.peak_metric[i] > res1.peak_metric[i]


def test_fine_kernel_matches_f64_reference():
    """The fine-frequency search, whose hypothesis combine is a matrix
    product pinned to full f32 precision, against the float64
    reference (acquisition/reference.py)."""
    import jax.numpy as jnp

    from cusdr_tpu.acquisition import pcps
    from cusdr_tpu.acquisition.reference import fine_inputs, fine_powers_f64
    from cusdr_tpu.tracking.reference import PARITY_TOL, parity_error

    a = fine_inputs(2.048e6)
    ref, norms = fine_powers_f64(*a)
    got = np.asarray(pcps._fine_kernel(*map(jnp.asarray, a[:5]), a[5]))
    assert np.argmax(got) == np.argmax(ref)
    assert parity_error(got[:, None], ref[:, None], norms) < PARITY_TOL


def test_pilot_phase_corr_matches_f64_reference():
    import jax.numpy as jnp

    from cusdr_tpu.acquisition import pcps
    from cusdr_tpu.acquisition.reference import (pilot_inputs,
                                                 pilot_phase_corr_f64)
    from cusdr_tpu.tracking.reference import PARITY_TOL, parity_error

    b = pilot_inputs(2.048e6)
    ref, norms = pilot_phase_corr_f64(*b)
    got = np.asarray(pcps._pilot_phase_corr(*map(jnp.asarray, b[:5]),
                                            b[5]))
    assert got.shape == ref.shape == (4, 75)
    assert parity_error(got, ref, norms) < PARITY_TOL
