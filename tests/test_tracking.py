"""Tracking engine tests: closed-loop lock on synthetic signals with known
Doppler/code-phase/C-N0 and nav-bit recovery."""

import numpy as np
import pytest

from cusdr_tpu import get_config
from cusdr_tpu.signals.defs import get_signal
from cusdr_tpu.io.synth import SynthSV, synthesize_if, quantize_iq_int8
from cusdr_tpu.tracking import track, calc_loop_coef


class TestLoopFilters:
    def test_calc_loop_coef_reference_values(self):
        # calcLoopCoef.m:41-45 with L1CA defaults
        tau1, tau2 = calc_loop_coef(1.5, 0.7, 1.0)
        wn = 1.5 * 8 * 0.7 / (4 * 0.49 + 1)
        assert np.isclose(tau1, 1.0 / wn ** 2)
        assert np.isclose(tau2, 1.4 / wn)


NAV_BITS = np.asarray([1, -1, 1, 1, -1, -1, -1, 1, -1, 1] * 12, np.int8)


@pytest.fixture(scope="module")
def tracked():
    cfg = get_config("gps_l1ca", sampling_freq=4.092e6, if_freq=9.548e3)
    sig = get_signal("gps_l1ca")
    svs = [SynthSV(prn=7, code_phase=1234.0, doppler_hz=2500.0,
                   cn0_dbhz=47, nav_bits=NAV_BITS),
           SynthSV(prn=13, code_phase=100.2, doppler_hz=-3200.0,
                   cn0_dbhz=44, nav_bits=NAV_BITS)]
    samples = quantize_iq_int8(synthesize_if(cfg, sig, svs, num_ms=900,
                                             seed=3))
    channels = [(7, 9548 + 2500, 1234), (13, 9548 - 3200, 101)]
    res = track(cfg, sig, samples, channels, n_epochs=800)
    return cfg, sig, svs, res


def test_phase_lock(tracked):
    """After convergence the Costas loop puts energy on I, not Q."""
    cfg, sig, svs, res = tracked
    for c in range(2):
        ip = np.abs(res.i_p[c, -300:]).mean()
        qp = np.abs(res.q_p[c, -300:]).mean()
        assert ip > 4 * qp, (c, ip, qp)


def test_carrier_frequency_converges(tracked):
    cfg, sig, svs, res = tracked
    for c, sv in enumerate(svs):
        truth = cfg.if_freq + sv.doppler_hz
        got = res.carr_freq[c, -200:].mean()
        assert abs(got - truth) < 15.0, (c, got, truth)


def test_code_frequency_tracks_code_doppler(tracked):
    cfg, sig, svs, res = tracked
    for c, sv in enumerate(svs):
        truth = sig.chip_rate_hz * (1 + sv.doppler_hz / sig.carrier_freq_hz)
        got = res.code_freq[c, -200:].mean()
        assert abs(got - truth) < 1.0, (c, got, truth)


def test_nav_bits_recovered(tracked):
    """Sign of I_P over each 20 ms bit must match the modulated nav bits."""
    cfg, sig, svs, res = tracked
    for c in range(2):
        ip = res.i_p[c]
        # bits start at epoch 0 (tracking starts at code start = bit edge
        # only when code_phase aligns; here synth starts bits at chip 0)
        n_bits = len(ip) // 20
        bit_sums = ip[:n_bits * 20].reshape(n_bits, 20).sum(axis=1)
        got = np.sign(bit_sums)
        expect = NAV_BITS[:n_bits]
        # polarity ambiguity of Costas loop: allow global flip
        agreement = np.mean(got == expect)
        assert agreement > 0.95 or agreement < 0.05, agreement


def test_cno_estimate_close(tracked):
    """VSM C/N0 within estimator scatter of truth (40 ms windows are
    noisy, CNoVSM.m:43-47), and stronger SV estimates higher."""
    cfg, sig, svs, res = tracked
    means = []
    for c, sv in enumerate(svs):
        m = np.mean(res.cno[c][5:])
        means.append(m)
        assert abs(m - sv.cn0_dbhz) < 5.0, (c, m, sv.cn0_dbhz)
    assert means[0] > means[1]


def test_absolute_sample_advances_one_code_period(tracked):
    cfg, sig, svs, res = tracked
    ds = np.diff(res.abs_sample[0])
    spc = cfg.samples_per_code
    assert np.all(np.abs(ds - spc) <= 2)


def test_offsets_past_int32_range():
    """Long-record correctness: sample offsets past 2**31 (a >115 s
    record at 18.6 Msps) must not wrap — the engine carries abs_sample
    as int64 and every window-offset computation must stay 64-bit
    (ADVICE r3 #1).  Same scene tracked at sb_start=0 and at
    sb_start=2**31+1e6 must produce identical correlators on both
    paths (XLA epoch, GPU correlator kernel interpreted)."""
    import dataclasses

    import jax.numpy as jnp

    from cusdr_tpu.tracking.engine import (build_replica_tables,
                                           init_channel_state,
                                           make_track_params,
                                           track_superblock)

    cfg = get_config("gps_l1ca", sampling_freq=2.048e6, if_freq=7000.0)
    sig = get_signal("gps_l1ca")
    params = make_track_params(cfg, sig)
    rng = np.random.default_rng(2)
    n_epochs = 6
    spc = cfg.samples_per_code
    samples = rng.integers(-16, 16,
                           2 * (n_epochs + 4) * spc).astype(np.int8)
    chans = [(7, 8500.0, 500), (9, 6000.0, 77)]
    dops = [c[1] - cfg.if_freq for c in chans]
    ct, pt = build_replica_tables(cfg, sig, params, chans, dops)
    state0 = init_channel_state(chans, sig.chip_rate_hz, dopplers=dops,
                                carrier_freq_hz=sig.carrier_freq_hz)
    big = np.int64(2 ** 31 + 1_000_000)
    state_big = state0._replace(abs_sample=state0.abs_sample + big)
    sd = jnp.asarray(samples.view(np.uint16))
    ctd, ptd = jnp.asarray(ct), jnp.asarray(pt)

    variants = {
        "xla": params,
        "kernel": dataclasses.replace(params, use_pallas=True,
                                      pallas_interpret=True),
    }
    for name, p in variants.items():
        ref_st, ref = track_superblock(sd, jnp.int64(0), ctd, ptd,
                                       state0, p, n_epochs)
        st, out = track_superblock(sd, jnp.int64(big), ctd, ptd,
                                   state_big, p, n_epochs)
        assert (np.asarray(out.blksize) > 0).all(), name
        np.testing.assert_allclose(np.asarray(out.i_p),
                                   np.asarray(ref.i_p),
                                   rtol=1e-6, atol=1e-4,
                                   err_msg=name)
        np.testing.assert_array_equal(np.asarray(st.abs_sample) - big,
                                      np.asarray(ref_st.abs_sample))


def test_packed_uint16_matches_int8_interleaved():
    """The packed uint16 sample layout (host .view of interleaved schar
    I/Q) must produce bit-identical tracking to the int8 interleaved
    form on every path — it is a relayout, not a numeric change."""
    import jax.numpy as jnp

    from cusdr_tpu.tracking.engine import (build_replica_tables,
                                           init_channel_state,
                                           make_track_params,
                                           track_superblock)

    cfg = get_config("gps_l1ca", sampling_freq=2.048e6, if_freq=7000.0)
    sig = get_signal("gps_l1ca")
    params = make_track_params(cfg, sig)
    rng = np.random.default_rng(5)
    n_epochs = 5
    spc = cfg.samples_per_code
    samples = rng.integers(-16, 16,
                           2 * (n_epochs + 4) * spc).astype(np.int8)
    chans = [(7, 8500.0, 500), (9, 6000.0, 77)]
    dops = [c[1] - cfg.if_freq for c in chans]
    ct, pt = build_replica_tables(cfg, sig, params, chans, dops)
    state = init_channel_state(chans, sig.chip_rate_hz, dopplers=dops,
                               carrier_freq_hz=sig.carrier_freq_hz)
    ctd, ptd = jnp.asarray(ct), jnp.asarray(pt)
    st8, out8 = track_superblock(jnp.asarray(samples), jnp.int64(0),
                                 ctd, ptd, state, params, n_epochs)
    st16, out16 = track_superblock(
        jnp.asarray(samples.view(np.uint16)), jnp.int64(0),
        ctd, ptd, state, params, n_epochs)
    for f in ("i_p", "q_p", "i_e", "q_l", "abs_sample", "blksize"):
        np.testing.assert_array_equal(np.asarray(getattr(out8, f)),
                                      np.asarray(getattr(out16, f)), f)
    np.testing.assert_array_equal(np.asarray(st8.carr_freq),
                                  np.asarray(st16.carr_freq))
