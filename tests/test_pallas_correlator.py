"""The fused GPU correlator kernel (interpret mode on CPU) and the XLA
epoch against the float64 reference epoch (tracking/reference.py), the
kernel against the XLA epoch over closed-loop scans, and the choice of
correlator path by backend."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cusdr_tpu import get_config
from cusdr_tpu.ops import correlator
from cusdr_tpu.signals.defs import get_signal
from cusdr_tpu.tracking.engine import (build_replica_tables,
                                       epoch_correlators,
                                       init_channel_state,
                                       make_track_params,
                                       track_superblock)
from cusdr_tpu.tracking.reference import (PARITY_TOL, epoch_correlators_f64,
                                          parity_error, random_bank)


def _kernel(params):
    return dataclasses.replace(params, use_pallas=True,
                               pallas_interpret=True)


# (signal, fs, pilot_trk_flag, interp_taps, sb_start) — small widths of
# the cases the on-card parity phase runs at full width
CASES = {
    "l1ca": ("gps_l1ca", 2.048e6, 0, True, 0),
    "e5a_pilot": ("gal_e5a", 12.288e6, 1, True, 0),
    "b1c_dual_pilot": ("bds_b1c", 10.23e6, 2, True, 0),
    "l2c_long_pilot": ("gps_l2c", 2.048e6, 1, True, 0),
    "nearest_taps": ("gps_l1ca", 2.048e6, 0, False, 0),
    "offsets_past_int32": ("gps_l1ca", 2.048e6, 0, True, 2 ** 31 + 12345),
}


@pytest.mark.parametrize("path", ["xla", "kernel"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_correlators_match_f64_reference(case, path):
    signal, fs, pilot, interp, sb_start = CASES[case]
    samples, sb, ct, pt, state, params = random_bank(
        signal, fs, pilot, n_ch=5, seed=3, interp_taps=interp,
        sb_start=sb_start)
    if path == "kernel":
        params = _kernel(params)
    ref, norms = epoch_correlators_f64(samples, sb, ct, pt, state, params)
    got = epoch_correlators(jnp.asarray(samples), jnp.int64(sb),
                            jnp.asarray(ct), jnp.asarray(pt), state,
                            params)
    assert np.abs(ref).max() > 0
    if pilot:
        assert np.abs(ref[:, 6:]).max() > 0
    err = parity_error(got, ref, norms)
    assert err < PARITY_TOL, err


@pytest.mark.parametrize("signal,fs,pilot", [
    ("gps_l1ca", 2.048e6, 0),
    ("gal_e5a", 12.288e6, 1),
    # WB QMBOC dual pilot bank (B1C, pilot_trk_flag=2)
    ("bds_b1c", 16.368e6, 2),
])
def test_kernel_matches_xla_closed_loop(signal, fs, pilot):
    cfg = get_config(signal, sampling_freq=fs, if_freq=7000.0,
                     pilot_trk_flag=pilot)
    sig = get_signal(signal)
    params = make_track_params(cfg, sig)
    spc = cfg.samples_per_code
    n_epochs = 12
    n_ch = 3
    rng = np.random.default_rng(7)
    samples = rng.integers(-16, 16, 2 * (n_epochs + 4) * spc).astype(
        np.int8)
    channels = [(1 + k, 7000.0 + 200.0 * k, 101 + 37 * k)
                for k in range(n_ch)]
    dops = [c[1] - cfg.if_freq for c in channels]
    ctabs, ptabs = build_replica_tables(cfg, sig, params, channels, dops)
    state = init_channel_state(channels, sig.chip_rate_hz, dopplers=dops,
                               carrier_freq_hz=sig.carrier_freq_hz)
    args = (jnp.asarray(samples), jnp.int64(0), jnp.asarray(ctabs),
            jnp.asarray(ptabs), state)
    st_x, out_x = track_superblock(*args, params, n_epochs)
    st_k, out_k = track_superblock(*args, _kernel(params), n_epochs)

    for name in ("i_e", "q_e", "i_p", "q_p", "i_l", "q_l",
                 "pilot_ip", "pilot_qp"):
        a = np.asarray(getattr(out_x, name))
        b = np.asarray(getattr(out_k, name))
        scale = np.abs(a).max() + 1.0
        assert np.allclose(a, b, atol=2e-4 * scale), (
            name, np.abs(a - b).max(), scale)
    # loop states agree to f32 rounding of the correlators carried
    # through the loop gains (1e-4 rad over 12 epochs)
    for name in ("carr_freq", "code_freq", "rem_code_phase",
                 "rem_carr_phase"):
        a = np.asarray(getattr(st_x, name))
        b = np.asarray(getattr(st_k, name))
        assert np.allclose(a, b, rtol=1e-6, atol=1e-4), (name, a, b)
    assert np.array_equal(np.asarray(st_x.abs_sample),
                          np.asarray(st_k.abs_sample))


def test_nearest_tap_mode_parity_all_paths():
    """interp_taps=False (the reference's own ceil-index fidelity,
    tracking.m:252-270) must agree between the XLA epoch and the kernel,
    and still achieve code/carrier lock."""
    from cusdr_tpu.io.synth import SynthSV, quantize_iq_int8, synthesize_if

    cfg = get_config("gps_l1ca", sampling_freq=2.048e6, if_freq=7000.0,
                     interp_taps=False)
    sig = get_signal("gps_l1ca")
    params = make_track_params(cfg, sig)
    assert not params.interp_taps
    iq = quantize_iq_int8(synthesize_if(
        cfg, sig,
        [SynthSV(prn=7, code_phase=500.0, doppler_hz=1500.0,
                 cn0_dbhz=48)], num_ms=30, seed=4))
    chans = [(7, 8500.0, 500), (9, 6000.0, 77)]
    dops = [c[1] - cfg.if_freq for c in chans]
    ct, pt = build_replica_tables(cfg, sig, params, chans, dops)
    st0 = init_channel_state(chans, sig.chip_rate_hz, dopplers=dops,
                             carrier_freq_hz=sig.carrier_freq_hz)
    sd = jnp.asarray(iq.view(np.uint16))
    ctd, ptd = jnp.asarray(ct), jnp.asarray(pt)
    res = {}
    for name, p in [("xla", params), ("kernel", _kernel(params))]:
        _, out = track_superblock(sd, jnp.int64(0), ctd, ptd, st0, p, 20)
        res[name] = np.asarray(out.i_p)
    d = np.abs(res["kernel"] - res["xla"]).max() / (
        np.abs(res["xla"]).max() + 1)
    assert d < 2e-4, d
    assert np.abs(res["xla"][5:, 0]).mean() > 500   # locked


@pytest.mark.parametrize("layout", ["int8", "int16"])
def test_kernel_sample_layouts(layout):
    """The kernel reads int8 planes (from the packed uint16 or
    interleaved int8 record) and int16 planes (cfg.data_type == "int16")
    with the same sums as the XLA epoch on the same layout."""
    samples, sb, ct, pt, state, params = random_bank(
        "gps_l1ca", 2.048e6, n_ch=3, seed=5)
    rec = samples.view(np.int8)
    if layout == "int16":
        rec = rec.astype(np.int16) * 3
    args = (jnp.asarray(rec), jnp.int64(sb), jnp.asarray(ct),
            jnp.asarray(pt), state)
    x = np.asarray(epoch_correlators(*args, params))
    k = np.asarray(epoch_correlators(*args, _kernel(params)))
    assert np.abs(x).max() > 0
    assert np.allclose(x, k, rtol=1e-5, atol=1e-3 * np.abs(x).max())


def test_kernel_under_vmap():
    """pallas_call's batching rule: a vmapped kernel epoch equals the
    per-bank calls (the vmapped time-block path relies on it)."""
    samples, sb, ct, pt, state, params = random_bank(
        "gps_l1ca", 2.048e6, n_ch=3, seed=9)
    kp = _kernel(params)
    sd, ctd, ptd = jnp.asarray(samples), jnp.asarray(ct), jnp.asarray(pt)
    states = jax.tree.map(lambda x: jnp.stack([x, x]), state)
    states = states._replace(
        abs_sample=states.abs_sample + jnp.asarray([[0], [1000]]))
    batched = jax.vmap(lambda st: epoch_correlators(
        sd, jnp.int64(sb), ctd, ptd, st, kp))(states)
    for b in range(2):
        one = epoch_correlators(sd, jnp.int64(sb), ctd, ptd,
                                jax.tree.map(lambda x: x[b], states), kp)
        np.testing.assert_allclose(np.asarray(batched[b]),
                                   np.asarray(one), rtol=1e-6, atol=1e-3)


def test_path_choice_by_backend():
    """Auto policy: the kernel on GPU backends, the XLA epoch elsewhere;
    asking for the kernel off the GPU raises instead of falling back."""
    cfg = get_config("gps_l1ca", sampling_freq=2.048e6, if_freq=7000.0)
    sig = get_signal("gps_l1ca")
    assert jax.devices()[0].platform == "cpu"
    assert not make_track_params(cfg, sig).use_pallas
    assert not make_track_params(cfg.replace(use_pallas=False),
                                 sig).use_pallas
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        make_track_params(cfg.replace(use_pallas=True), sig)


def test_kernel_off_gpu_without_interpret_raises():
    samples, sb, ct, pt, state, params = random_bank(
        "gps_l1ca", 2.048e6, n_ch=2, seed=1)
    p = dataclasses.replace(params, use_pallas=True)
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        epoch_correlators(jnp.asarray(samples), jnp.int64(sb),
                          jnp.asarray(ct), jnp.asarray(pt), state, p)


@pytest.mark.parametrize("blk,rows", [(2056, 3), (18008, 12),
                                      (18008, 1200), (180008, 12),
                                      (100, 1)])
def test_kernel_geometry(blk, rows):
    """Launch geometry: power-of-two chunks of whole tiles covering the
    window, grown only while the grid keeps MIN_PROGRAMS programs."""
    tpc, n_chunks, span = correlator.geometry(blk, rows)
    assert tpc & (tpc - 1) == 0
    assert 1 <= tpc <= correlator.MAX_TILES_PER_CHUNK
    assert span == n_chunks * tpc * correlator.TILE >= blk
    assert span - blk < tpc * correlator.TILE
    if tpc > 1:
        assert rows * n_chunks >= correlator.MIN_PROGRAMS
