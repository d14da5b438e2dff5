"""Time-block (sequence-parallel) tracking: concurrent blocks must match
sequential tracking after the per-block settle transient."""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from cusdr_tpu import get_config
from cusdr_tpu.io.synth import SynthSV, quantize_iq_int8, synthesize_if
from cusdr_tpu.parallel.timeblocks import track_time_parallel
from cusdr_tpu.signals.defs import get_signal
from cusdr_tpu.tracking import track


@pytest.fixture(scope="module")
def scene():
    cfg = get_config("gps_l1ca", sampling_freq=2.048e6, if_freq=7000.0)
    sig = get_signal("gps_l1ca")
    rng = np.random.default_rng(0)
    svs = [SynthSV(prn=7, code_phase=1234.0, doppler_hz=2500.0,
                   cn0_dbhz=47,
                   nav_bits=rng.choice(np.asarray([-1, 1], np.int8), 300)),
           SynthSV(prn=13, code_phase=100.2, doppler_hz=-3200.0,
                   cn0_dbhz=45,
                   nav_bits=rng.choice(np.asarray([-1, 1], np.int8), 300))]
    iq = quantize_iq_int8(synthesize_if(cfg, sig, svs, num_ms=4200,
                                        seed=3))
    chans = [(7, 9500.0, 1234), (13, 3800.0, 101)]
    seq = track(cfg, sig, iq, chans, n_epochs=4000)
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("tb",))
    par = track_time_parallel(cfg, sig, iq, chans, n_epochs=4000,
                              n_blocks=4, mesh=mesh)
    return cfg, seq, par


def test_carrier_matches_sequential(scene):
    cfg, seq, par = scene
    for c in range(2):
        for b in range(4):
            lo, hi = b * 1000 + 300, (b + 1) * 1000
            assert abs(seq.carr_freq[c, lo:hi].mean()
                       - par.carr_freq[c, lo:hi].mean()) < 1.0


def test_code_freq_matches_sequential(scene):
    cfg, seq, par = scene
    for c in range(2):
        for b in range(4):
            lo, hi = b * 1000 + 300, (b + 1) * 1000
            assert abs(seq.code_freq[c, lo:hi].mean()
                       - par.code_freq[c, lo:hi].mean()) < 0.05


def test_lock_quality_preserved(scene):
    """Steady-state correlation amplitude within a few % of sequential."""
    cfg, seq, par = scene
    for c in range(2):
        for b in range(4):
            lo, hi = b * 1000 + 300, (b + 1) * 1000
            env_s = np.hypot(seq.i_p[c, lo:hi], seq.q_p[c, lo:hi]).mean()
            env_p = np.hypot(par.i_p[c, lo:hi], par.q_p[c, lo:hi]).mean()
            assert env_p > 0.9 * env_s


def test_absolute_samples_continuous(scene):
    """Block stitching: absolute sample indices must stay monotonic with
    one-code-period steps across block boundaries."""
    cfg, seq, par = scene
    spc = cfg.samples_per_code
    ds = np.diff(par.abs_sample[0])
    assert np.all(ds > 0)
    assert np.abs(ds - spc).max() <= spc  # boundary step may differ by <1 period


def test_exact_handoff_parity(scene):
    """With handoff_iters = n_blocks-1, every block has re-run from its
    left neighbor's true final state, so the stitched trajectory IS the
    sequential one (same kernel, same epoch order) within float noise."""
    cfg, seq, par3 = None, None, None
    cfg, seq, _ = scene
    sig = get_signal("gps_l1ca")
    rng = np.random.default_rng(0)
    svs = [SynthSV(prn=7, code_phase=1234.0, doppler_hz=2500.0,
                   cn0_dbhz=47,
                   nav_bits=rng.choice(np.asarray([-1, 1], np.int8), 300)),
           SynthSV(prn=13, code_phase=100.2, doppler_hz=-3200.0,
                   cn0_dbhz=45,
                   nav_bits=rng.choice(np.asarray([-1, 1], np.int8), 300))]
    iq = quantize_iq_int8(synthesize_if(cfg, sig, svs, num_ms=4200,
                                        seed=3))
    chans = [(7, 9500.0, 1234), (13, 3800.0, 101)]
    par = track_time_parallel(cfg, sig, iq, chans, n_epochs=4000,
                              n_blocks=4, handoff_iters=3)
    assert par.settle_epochs == 0
    np.testing.assert_array_equal(par.abs_sample, seq.abs_sample)
    np.testing.assert_allclose(par.carr_freq, seq.carr_freq,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(par.code_freq, seq.code_freq,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(par.i_p, seq.i_p, rtol=1e-4, atol=0.5)
    np.testing.assert_allclose(par.q_p, seq.q_p, rtol=1e-4, atol=0.5)


def test_single_handoff_converged_blocks(scene):
    """handoff_iters=1 (the shipped default): blocks 0 and 1 are exactly
    sequential; later blocks agree after their (already converged)
    start."""
    cfg, seq, par = scene
    epb = 1000
    np.testing.assert_allclose(par.carr_freq[:, :2 * epb],
                               seq.carr_freq[:, :2 * epb],
                               rtol=0, atol=1e-6)
    # converged later blocks: same trajectory within loop noise
    tail = slice(2 * epb, 4 * epb)
    assert np.abs(par.carr_freq[:, tail]
                  - seq.carr_freq[:, tail]).max() < 2.0


def test_flat_path_matches_block_path(scene):
    """The single-device flat formulation (one B*C-row bank over the full
    record, the GPU correlator kernel reading windows straight from it)
    must reproduce the per-block vmapped XLA path's trajectories
    (interpret-mode kernel on CPU)."""
    import dataclasses

    import jax.numpy as jnp

    from cusdr_tpu.parallel.timeblocks import (_track_blocks,
                                               _track_blocks_flat,
                                               predict_block_states)
    from cusdr_tpu.tracking.engine import (build_replica_tables,
                                           make_track_params)

    cfg, _, _ = scene
    sig = get_signal("gps_l1ca")
    rng = np.random.default_rng(1)
    svs = [SynthSV(prn=7, code_phase=500.0, doppler_hz=1500.0,
                   cn0_dbhz=48)]
    iq = quantize_iq_int8(synthesize_if(cfg, sig, svs, num_ms=50, seed=4))
    chans = [(7, 8500.0, 500), (9, 6000.0, 77), (21, 7500.0, 900)]
    n_blocks, epb = 2, 20
    params = make_track_params(cfg, sig)
    params_pl = dataclasses.replace(params, use_pallas=True,
                                    pallas_interpret=True)
    dops = [c[1] - cfg.if_freq for c in chans]
    ct, pt = build_replica_tables(cfg, sig, params, chans, dops)
    states, _ = predict_block_states(chans, cfg, sig, n_blocks, epb)

    spc = cfg.samples_per_code
    total = len(iq) // 2
    st_f, out_f = _track_blocks_flat(jnp.asarray(iq), jnp.asarray(ct),
                                     jnp.asarray(pt), states, params_pl,
                                     epb, n_blocks)

    blk_len = (epb + 4) * spc + params.blk + 256
    starts = np.asarray(states.abs_sample).min(axis=1)
    sb = np.zeros((n_blocks, 2 * blk_len), np.int8)
    s0s = np.zeros(n_blocks, np.int64)
    s1s = np.zeros(n_blocks, np.int64)
    for b in range(n_blocks):
        s0 = max(int(starts[b]) - spc, 0)
        s1 = min(s0 + blk_len, total)
        s0s[b], s1s[b] = s0, s1
        sb[b, :2 * (s1 - s0)] = iq[2 * s0:2 * s1]
    st_b, out_b = _track_blocks(jnp.asarray(sb), jnp.asarray(s0s),
                                jnp.asarray(s1s), jnp.asarray(ct),
                                jnp.asarray(pt), states, params,
                                epb)
    for name in ("i_p", "q_p", "i_e", "q_l"):
        a = np.asarray(getattr(out_b, name))
        bv = np.asarray(getattr(out_f, name))
        scale = np.abs(a).max() + 1.0
        assert np.allclose(a, bv, atol=2e-4 * scale), (
            name, np.abs(a - bv).max(), scale)
    np.testing.assert_array_equal(np.asarray(st_b.abs_sample),
                                  np.asarray(st_f.abs_sample))
    np.testing.assert_allclose(np.asarray(st_b.carr_freq),
                               np.asarray(st_f.carr_freq),
                               rtol=1e-6, atol=1e-6)
