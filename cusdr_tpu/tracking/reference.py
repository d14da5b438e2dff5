"""Plain float64 reference of one tracking epoch's correlator sums.

A direct numpy evaluation of the definition (GPS/GPS_L1CA/include/
tracking.m:252-300 with the pre-sampled replica of the fast path, plus
the pilot correlators of GPS_L5C/include/tracking.m:334-345 and the
composite QMBOC pilot of BDS/B1C WB_tracking.m:364-369), written
independently of the engine's XLA epoch and of the GPU kernel, so that
both can be compared with it: every per-sample quantity in float64, the
carrier phase evaluated exactly, the windows clamped as a dynamic slice
clamps them.
"""

from __future__ import annotations

import numpy as np


def _planes(samples_iq: np.ndarray):
    """I and Q planes (float64) of a packed uint16 / interleaved record."""
    x = np.asarray(samples_iq)
    if x.dtype == np.uint16:
        x = x.view(np.int8)
    return x[0::2].astype(np.float64), x[1::2].astype(np.float64)


def _rotate(z: np.ndarray, rot: int) -> np.ndarray:
    return z * (1j ** rot)


# Parity tolerance, relative to each channel's baseband norm ||bb||_2
# (see parity_error).  Every sum is sum_n rep(n)·bb(n) with |rep| <= 1; a
# path whose per-sample products carry independent relative errors of
# size e is off by about e·||bb||_2.  f32 arithmetic with carrier phases
# exact to f32 rounding gives e of a few 1e-7 (both paths measure below
# 1e-6 at 180k-sample epochs).  TF32 rounds both factors of each product
# to 10 mantissa bits (e up to 2^-11, rms ~2.8e-4), more than ten times
# the tolerance.
PARITY_TOL = 2e-5

# Parity cases at the widths the receiver runs on the card:
# name -> (signal, fs, pilot_trk_flag, interp_taps, sb_start).  B1C
# wideband at 18 Msps has 10 ms epochs of ~180k samples; the last case
# puts every window offset past 2^31 absolute samples.
CARD_CASES = {
    "l1ca": ("gps_l1ca", 18e6, 0, True, 0),
    "e5a_pilot": ("gal_e5a", 18e6, 1, True, 0),
    "b1c_dual_pilot": ("bds_b1c", 18e6, 2, True, 0),
    "l1ca_nearest_taps": ("gps_l1ca", 18e6, 0, False, 0),
    "l1ca_offsets_past_int32": ("gps_l1ca", 18e6, 0, True, 2 ** 31 + 12345),
}


def parity_error(got, ref, norms) -> float:
    """Largest |got - ref| over a bank's sums, in units of the channel's
    baseband norm (norms: [C] from epoch_correlators_f64)."""
    err = np.abs(np.asarray(got, np.float64) - ref)
    return float((err / np.maximum(norms, 1e-30)[:, None]).max())


def _channel_terms(samples_iq, sb_start, code_tables, pilot_tables,
                   state, p):
    """Per channel: (baseband [blk] complex, data taps [3, blk], pilot
    tap banks [n_banks, 3, blk]) of the bank's next epoch, float64."""
    assert p.fast_code
    sig_i, sig_q = _planes(samples_iq)
    n_samples = len(sig_i)
    st = {f: np.asarray(getattr(state, f)) for f in state._fields}
    ct = np.asarray(code_tables).astype(np.float64)
    pt = np.asarray(pilot_tables).astype(np.float64)
    k = p.k_spacing
    wlen = p.blk + 2 * k + 1
    n = np.arange(p.blk)

    def window(tab, chips_f, step_f):
        shift_f = chips_f / step_f
        shift = int(np.floor(shift_f))
        alpha = shift_f - shift
        s0 = int(np.clip(p.up_margin + shift - k, 0,
                         tab.shape[-1] - wlen))
        w = tab[s0:s0 + wlen]
        taps = []
        for d in (0, k, 2 * k):
            a = w[d:d + p.blk]
            if p.interp_taps:
                a = a + alpha * (w[d + 1:d + 1 + p.blk] - a)
            taps.append(a)
        return np.asarray(taps)

    for c in range(len(st["abs_sample"])):
        step = st["code_freq"][c] / p.fs
        bsz = min(int(np.ceil((p.code_len - st["rem_code_phase"][c])
                              / step)), p.blk)
        off = int(np.clip(int(st["abs_sample"][c]) - int(sb_start), 0,
                          n_samples - p.blk))
        cyc = st["rem_carr_phase"][c] / (2 * np.pi) + st["carr_freq"][c] \
            / p.fs * n
        bb = ((sig_i[off:off + p.blk] + 1j * sig_q[off:off + p.blk])
              * np.exp(-2j * np.pi * cyc) * (n < bsz))
        data = window(ct[c], st["rem_code_phase"][c], step)
        banks = []
        if p.has_pilot:
            pchips, pstep = st["rem_code_phase"][c], step
            if p.pilot_period_mod > 1:
                pchips = pchips + float(st["pilot_period"][c]) * p.code_len
                pstep = st["code_freq_basis"][c] / p.fs
            tabs = [pt[c, 0], pt[c, 1]] if p.has_pilot2 else [pt[c]]
            banks = [window(t, pchips, pstep) for t in tabs]
        yield bb, data, banks


def epoch_correlators_f64(samples_iq, sb_start, code_tables, pilot_tables,
                          state, params):
    """Correlator sums [C, 12] (iE qE iP qP iL qL piE pqE piP pqP piL pqL)
    of the bank's next epoch in float64, and each channel's baseband
    norm ||bb||_2 [C] (the scale of parity_error).

    Arguments as for tracking.engine.epoch_correlators (fast replica
    path: params.fast_code)."""
    p = params
    out, norms = [], []
    for bb, data, banks in _channel_terms(samples_iq, sb_start,
                                          code_tables, pilot_tables,
                                          state, p):
        z = data @ bb
        zp = np.zeros(3, complex)
        if banks:
            zp = _rotate(banks[0] @ bb, p.pilot_rot)
            if p.has_pilot2:
                zp = (p.pilot_w1 * zp
                      + p.pilot_w2 * _rotate(banks[1] @ bb, p.pilot2_rot))
        both = np.concatenate([z, zp])
        out.append(np.stack([both.real, both.imag], axis=1).reshape(12))
        norms.append(np.sqrt((np.abs(bb) ** 2).sum()))
    return np.asarray(out), np.asarray(norms)


def data_terms_f64(samples_iq, sb_start, code_tables, pilot_tables, state,
                   params):
    """The two factors of the data correlators, float64: baseband
    [C, blk] complex and E/P/L replica taps [C, 3, blk] (their product
    over the window is the first six sums of epoch_correlators_f64)."""
    terms = list(_channel_terms(samples_iq, sb_start, code_tables,
                                pilot_tables, state, params))
    return (np.asarray([t[0] for t in terms]),
            np.asarray([t[1] for t in terms]))


def random_bank(signal: str, fs: float, pilot_trk_flag: int = 0,
                n_ch: int = 12, seed: int = 0, interp_taps: bool = True,
                sb_start: int = 0, n_periods: int = 3):
    """A bank of ``n_ch`` channels over a random int8 record at a preset's
    widths, for the parity checks.  Channels get spread Dopplers, code
    phases and fractional loop state, so window offsets, interpolation
    fractions and carrier phases all vary across the bank.

    Returns (samples packed uint16, sb_start, code_tables, pilot_tables,
    state, params) with params on the XLA epoch (use_pallas=False)."""
    import jax.numpy as jnp

    from ..config import get_config
    from ..signals.defs import get_signal
    from .engine import (build_replica_tables, init_channel_state,
                         make_track_params)

    cfg = get_config(signal, sampling_freq=fs, if_freq=20e3,
                     pilot_trk_flag=pilot_trk_flag, use_pallas=False,
                     interp_taps=interp_taps)
    sig = get_signal(signal)
    params = make_track_params(cfg, sig)
    spc = cfg.samples_per_code
    rng = np.random.default_rng(seed)
    samples = rng.integers(-16, 16, 2 * (n_periods + 2) * spc).astype(
        np.int8)
    chans = [(1 + c, cfg.if_freq + 397.0 * c - 2000.0,
              int(rng.integers(0, spc))) for c in range(n_ch)]
    dops = [ch[1] - cfg.if_freq for ch in chans]
    ctabs, ptabs = build_replica_tables(cfg, sig, params, chans, dops)
    state = init_channel_state(chans, sig.chip_rate_hz, dopplers=dops,
                               carrier_freq_hz=sig.carrier_freq_hz)
    step = np.asarray(state.code_freq) / fs
    state = state._replace(
        abs_sample=state.abs_sample + np.int64(sb_start),
        rem_code_phase=jnp.asarray(rng.random(n_ch) * step),
        rem_carr_phase=jnp.asarray(rng.random(n_ch) * 2 * np.pi),
        pilot_period=jnp.asarray(
            rng.integers(0, max(params.pilot_period_mod, 1), n_ch),
            jnp.int32))
    return (samples.view(np.uint16), sb_start, ctabs, ptabs, state,
            params)
