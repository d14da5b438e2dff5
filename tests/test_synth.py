"""Synthetic IF records: the chunked multi-process int8 generator."""

import numpy as np

from cusdr_tpu import get_config
from cusdr_tpu.acquisition import acquire
from cusdr_tpu.io.synth import (SynthSV, _synth_range, quantize_iq_int8,
                                synthesize_iq_int8)
from cusdr_tpu.signals.defs import get_signal


def _scene():
    cfg = get_config("gps_l1ca", sampling_freq=2.048e6, if_freq=7000.0,
                     acq_satellite_list=(5, 9), acq_non_coh_time=4)
    sig = get_signal("gps_l1ca")
    sv = SynthSV(prn=9, code_phase=777.0, doppler_hz=500.0, cn0_dbhz=48)
    return cfg, sig, [sv]


def test_int8_record_independent_of_workers():
    """Chunk k's noise comes from the (seed, k) stream, so the record is
    the same whatever the number of worker processes."""
    cfg, sig, svs = _scene()
    one = synthesize_iq_int8(cfg, sig, svs, num_ms=50, seed=5,
                             chunk_ms=20, workers=1)
    two = synthesize_iq_int8(cfg, sig, svs, num_ms=50, seed=5,
                             chunk_ms=20, workers=2)
    np.testing.assert_array_equal(one, two)
    assert one.dtype == np.int8 and one.size == 2 * int(50 * 2048)
    # chunk 1 equals the direct evaluation with its own stream
    n = int(20e-3 * cfg.sampling_freq)
    direct = quantize_iq_int8(_synth_range(
        cfg, sig, svs, n, 2 * n, 4.0, np.random.default_rng([5, 1]), 0.5))
    np.testing.assert_array_equal(one[2 * n:4 * n], direct)
    other = synthesize_iq_int8(cfg, sig, svs, num_ms=50, seed=6,
                               chunk_ms=20)
    assert not np.array_equal(one, other)


def test_int8_record_acquires_planted_sv():
    cfg, sig, svs = _scene()
    iq = synthesize_iq_int8(cfg, sig, svs, num_ms=80, seed=5)
    acq = acquire(cfg, sig, iq[0::2].astype(np.float32)
                  + 1j * iq[1::2].astype(np.float32))
    i = list(acq.prns).index(9)
    assert acq.detected[i]
    err = abs(int(acq.code_phase[i]) - 777) % cfg.samples_per_code
    assert min(err, cfg.samples_per_code - err) <= 2
