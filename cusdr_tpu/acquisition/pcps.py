"""Batched PCPS (parallel code-phase search) acquisition.

Reference semantics: GPS/GPS_L1CA/include/acquisition.m — per-PRN FFT
circular correlation over Doppler bins with non-coherent accumulation, GLRT
peak metric (acquisition.m:155-200), then a fine-frequency stage via long
coherent integration with bit-edge/secondary-code hypothesis search
(acquisition.m:203-260).

Accelerator redesign (not a port):
  * the Doppler-mixed signal FFT is computed ONCE for all PRNs
    (the reference recomputes it per PRN: acquisition.m:167-191);
  * all (PRN × Doppler × non-coherent) work is one jitted program —
    `lax.scan` over PRNs, batched FFTs over [bins, blocks, samples];
  * joint multi-component acquisition (data+pilot envelope sums with ICD
    power weights) is a weighted reduction over a components axis,
    generalizing GAL_E1C/include/acquisition.m:195 and
    BDS/B1C/include/acquisition.m:213-214;
  * FDMA (GLONASS) folds the per-channel carrier offset into the Doppler
    grid per PRN slot (GLO_GL1/include/acquisition.m:181-182).
"""

from __future__ import annotations

import functools
import warnings
from dataclasses import dataclass
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..signals.defs import SignalDef, sample_code

# Device math is expressed over (real, imag) float32 pairs; the FFTs run
# on complex64 (cuFFT on GPU).  Matrix products are pinned to full f32
# precision: at the default precision a GPU may run them in TF32.
_HIGHEST = jax.lax.Precision.HIGHEST


def _fft_pair(xr, xi):
    y = jnp.fft.fft(jax.lax.complex(xr, xi), axis=-1)
    return jnp.real(y), jnp.imag(y)


def _ifft_pair(xr, xi):
    y = jnp.fft.ifft(jax.lax.complex(xr, xi), axis=-1)
    return jnp.real(y), jnp.imag(y)


@dataclass
class AcquisitionResult:
    """Per-PRN acquisition outputs (mirrors acqResults struct,
    acquisition.m:128-134)."""
    prns: np.ndarray           # PRN (or FDMA channel) ids searched
    carr_freq: np.ndarray      # detected carrier freq [Hz] (0 if none)
    code_phase: np.ndarray     # sample offset of code start (0-based)
    peak_metric: np.ndarray    # GLRT statistic peak/σ/N_noncoh
    detected: np.ndarray       # bool mask (metric > threshold)
    coarse_freq: np.ndarray    # coarse-stage bin freq [Hz]
    pilot_phase: np.ndarray | None = None   # long-pilot phase hypothesis
                                            # (L2C CL period index)

    def best_channels(self, n: int):
        """PRNs sorted by peak metric, detected first (preRun.m:60-72).

        Tuples are (prn, carr_freq, code_phase, pilot_phase) — the 4th
        element seeds the long-pilot period counter (L2C CLCodePhase,
        GPS_L2C/include/tracking.m:161-163)."""
        order = np.argsort(-self.peak_metric)
        order = [i for i in order if self.detected[i]][:n]
        pp = self.pilot_phase if self.pilot_phase is not None \
            else np.zeros(len(self.prns), np.int64)
        return [(int(self.prns[i]), float(self.carr_freq[i]),
                 int(self.code_phase[i]), int(pp[i])) for i in order]


# --------------------------------------------------------------------------
# Coarse stage
# --------------------------------------------------------------------------

def _mixed_fft(slabs_r, slabs_i, f_grid, ts):
    """FFT of the Doppler-mixed signal: pair of [n_bins, n_noncoh, nfft].

    Mixing by e^{-jθ}: (sr + j·si)(cosθ - j·sinθ)."""
    nfft = slabs_r.shape[-1]
    n = jnp.arange(nfft, dtype=jnp.float32)
    phase = (2.0 * jnp.pi * ts) * f_grid[:, None] * n[None, :]
    c = jnp.cos(phase)[:, None, :]
    sn = jnp.sin(phase)[:, None, :]
    mr = slabs_r[None] * c + slabs_i[None] * sn
    mi = slabs_i[None] * c - slabs_r[None] * sn
    return _fft_pair(mr, mi)


def _second_peak(row, peak_phase, period: int, excl_samples: int):
    """Largest value in ``row`` outside ±excl_samples of the peak,
    excluded PERIODICALLY (the true peak repeats every code period when
    the search spans more than one; GPS_L2C/include/acquisition.m:90-112).
    """
    lags = jnp.arange(row.shape[-1])
    d = jnp.mod(lags - peak_phase, period)
    dist = jnp.minimum(d, period - d)
    return jnp.max(jnp.where(dist > excl_samples, row, 0.0))


def _corr_peak(mf, cfftc, weights, n_comp, search_len=None,
               excl_samples: int = 0, period: Optional[int] = None):
    """Envelope-summed correlation peak for one PRN.

    mf: pair of [n_bins, n_noncoh, nfft]; cfftc: pair of [n_comp, nfft].
    The FFT length is padded to a power of two; only the first
    ``search_len`` lags (= 2 code periods, the reference's search span,
    acquisition.m:160-162) are scanned for the peak.
    Returns (peak, bin, phase, second_peak, floor) where second_peak is
    the largest value in the peak's Doppler row outside ±excl_samples of
    the peak (the L2C/B1I second-peak-ratio metric,
    GPS_L2C/include/acquisition.m:90-112) and floor is the measured mean
    of the whole weighted envelope surface — the noise-floor reference
    for the calibrated GLRT metric (the peak occupies a negligible
    fraction of the bins x lags points, so the mean is noise-dominated).
    """
    mfr, mfi = mf
    cfr, cfi = cfftc
    nfft = mfr.shape[-1]
    search = nfft if search_len is None else search_len
    acc = jnp.zeros((mfr.shape[0], search), jnp.float32)
    for c in range(n_comp):
        pr = mfr * cfr[c][None, None, :] - mfi * cfi[c][None, None, :]
        pi = mfr * cfi[c][None, None, :] + mfi * cfr[c][None, None, :]
        ir, ii = _ifft_pair(pr, pi)
        acc = acc + weights[c] * jnp.hypot(
            ir[..., :search], ii[..., :search]).sum(axis=1)
    flat = acc.reshape(-1)
    k = jnp.argmax(flat)
    peak_bin = k // search
    peak_phase = k % search
    spc = period if period is not None else search // 2
    second = _second_peak(acc[peak_bin], peak_phase, spc, excl_samples)
    return flat[k], peak_bin, peak_phase, second, jnp.mean(flat)


@functools.partial(jax.jit,
                   static_argnames=("n_noncoh", "n_comp", "search_len",
                                    "excl_samples", "period"))
def _pcps_cdma_kernel(slabs, code_fft_conj, weights, f_grid, ts,
                      n_noncoh: int, n_comp: int, search_len: int,
                      excl_samples: int = 0,
                      period: Optional[int] = None):
    """CDMA PCPS: the mixed-signal FFT is computed ONCE and shared by all
    PRNs (the reference recomputes it per PRN: acquisition.m:167-191).

    slabs: pair of [n_noncoh, nfft]; code_fft_conj: pair of
    [n_prn, n_comp, nfft]; f_grid [n_bins].
    Returns (peak, bin, phase, second, floor) each [n_prn].
    """
    mf = _mixed_fft(slabs[0], slabs[1], f_grid, ts)

    def one_prn(carry, cfftc):
        return carry, _corr_peak(mf, cfftc, weights, n_comp, search_len,
                                 excl_samples, period)

    _, out = jax.lax.scan(one_prn, 0, code_fft_conj)
    return out


@functools.partial(jax.jit,
                   static_argnames=("n_noncoh", "n_comp", "search_len",
                                    "excl_samples", "period"))
def _pcps_fdma_kernel(slabs, code_fft_conj, weights, freqs, ts,
                      n_noncoh: int, n_comp: int, search_len: int,
                      excl_samples: int = 0,
                      period: Optional[int] = None):
    """FDMA PCPS (GLONASS): one shared code, per-channel carrier grids
    (GLO_GL1/include/acquisition.m:181-182).

    freqs [n_chan, n_bins]; code_fft_conj: pair of [1, n_comp, nfft]
    (shared code).
    """
    def one_chan(carry, f_grid):
        mf = _mixed_fft(slabs[0], slabs[1], f_grid, ts)
        return carry, _corr_peak(mf, (code_fft_conj[0][0],
                                      code_fft_conj[1][0]),
                                 weights, n_comp, search_len,
                                 excl_samples, period)

    _, out = jax.lax.scan(one_chan, 0, freqs)
    return out


@functools.partial(jax.jit,
                   static_argnames=("n_shift", "n_comp", "search_len",
                                    "excl_samples", "period"))
def _pcps_circshift_kernel(slabs, code_fft_conj, weights, sub_offsets, ts,
                           n_shift: int, n_comp: int, search_len: int,
                           excl_samples: int = 0,
                           period: Optional[int] = None):
    """Circular-shift frequency search (GPS_L2C/include/acquisition.m:
    25,52-88): the signal is mixed and FFT'd only ``n_sub`` times (the
    sub-bin offsets); every other Doppler hypothesis is the spectrum
    ROTATED by an integer number of bins.  Versus the brute-force grid
    this removes all but n_sub forward FFTs and — decisive at long-code
    numerology like L2C (±10 kHz / 12.5 Hz = 1601 hypotheses over a
    2^19-point pair FFT) — never materializes the [bins, nfft] mixed
    tensor: a `lax.scan` over integer shifts keeps only one shift's
    product live while all PRNs' correlations for that shift run as one
    batched IFFT.

    slabs: pair of [n_noncoh, nfft]; code_fft_conj: pair of
    [n_prn, n_comp, nfft]; sub_offsets [n_sub] absolute mix frequencies.
    Hypothesis (m, j) ≡ carrier  sub_offsets[j] − m·fs/nfft  (spectrum
    content at −m bins is brought to DC by circshift(+m),
    acquisition.m:71-84,119).
    Returns (peak, shift_idx, sub_idx, phase, second, floor) each [n_prn].
    """
    mfr, mfi = _mixed_fft(slabs[0], slabs[1], sub_offsets, ts)
    n_sub = mfr.shape[0]
    cfr, cfi = code_fft_conj
    n_prn = cfr.shape[0]
    per = period if period is not None else search_len // 2

    def rows(rr, ri):
        """All-PRN envelope rows for one integer shift:
        [n_prn, n_sub, search]."""
        acc = jnp.zeros((n_prn, n_sub, search_len), jnp.float32)
        for c in range(n_comp):
            ar = cfr[:, c][:, None, None, :]
            ai = cfi[:, c][:, None, None, :]
            pr = rr[None] * ar - ri[None] * ai
            pi = rr[None] * ai + ri[None] * ar
            ir, ii = _ifft_pair(pr, pi)
            acc = acc + weights[c] * jnp.hypot(
                ir[..., :search_len], ii[..., :search_len]).sum(axis=2)
        return acc

    def step(carry, m):
        b_val, b_m, b_sub, b_ph, b_row, b_floor = carry
        rr = jnp.roll(mfr, m, axis=-1)
        ri = jnp.roll(mfi, m, axis=-1)
        acc = rows(rr, ri)
        flat = acc.reshape(n_prn, -1)
        k = jnp.argmax(flat, axis=1)
        val = jnp.take_along_axis(flat, k[:, None], axis=1)[:, 0]
        sub = (k // search_len).astype(jnp.int32)
        ph = (k % search_len).astype(jnp.int32)
        row = jnp.take_along_axis(acc, sub[:, None, None], axis=1)[:, 0]
        imp = val > b_val
        carry = (jnp.where(imp, val, b_val),
                 jnp.where(imp, m, b_m),
                 jnp.where(imp, sub, b_sub),
                 jnp.where(imp, ph, b_ph),
                 jnp.where(imp[:, None], row, b_row),
                 b_floor + flat.mean(axis=1))
        return carry, None

    init = (jnp.full(n_prn, -jnp.inf, jnp.float32),
            jnp.zeros(n_prn, jnp.int32), jnp.zeros(n_prn, jnp.int32),
            jnp.zeros(n_prn, jnp.int32),
            jnp.zeros((n_prn, search_len), jnp.float32),
            jnp.zeros(n_prn, jnp.float32))
    (val, m, sub, ph, row, floor), _ = jax.lax.scan(
        init=init, xs=jnp.arange(n_shift, dtype=jnp.int32), f=step)
    second = jax.vmap(lambda r, p: _second_peak(r, p, per, excl_samples)
                      )(row, ph)
    return val, m, sub, ph, second, floor / n_shift


# --------------------------------------------------------------------------
# Fine stage
# --------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("envelope",))
def _fine_kernel(sig_r, sig_i, code_replica, freqs, hyp, ts,
                 envelope: bool = False):
    """Fine-frequency search by long coherent integration.

    sig_r/sig_i:  [n_codes * spc] float32 I/Q starting at the code edge
    code_replica: [n_codes * spc] float32 (±1 sampled replica)
    freqs:        [n_fine] float32 candidate carrier frequencies
    hyp:          [n_hyp, n_codes] float32 — coherent-combination
                  hypotheses over per-code sums (bit-edge windows,
                  NH/secondary-code phases; acquisition.m:235-248,
                  GPS_L5C/include/acquisition.m:241-275)
    envelope:     sum |per-code sums| instead (data-sign-insensitive fine
                  search for long-code signals, B1C-style)

    Returns power [n_fine] (max over hypotheses).
    """
    n_codes = hyp.shape[1]
    spc = sig_r.shape[0] // n_codes
    n = jnp.arange(sig_r.shape[0], dtype=jnp.float32)
    wr = sig_r * code_replica
    wi = sig_i * code_replica

    def one_freq(f):
        phase = (2.0 * jnp.pi * ts) * f * n
        c, sn = jnp.cos(phase), jnp.sin(phase)
        sr = (wr * c + wi * sn).reshape(n_codes, spc).sum(axis=1)
        si = (wi * c - wr * sn).reshape(n_codes, spc).sum(axis=1)
        if envelope:
            return jnp.sum(jnp.hypot(sr, si))
        return jnp.max(jnp.hypot(jnp.dot(hyp, sr, precision=_HIGHEST),
                                 jnp.dot(hyp, si, precision=_HIGHEST)))

    return jax.vmap(one_freq)(freqs)


@jax.jit
def _pilot_phase_corr(sig_r, sig_i, cps, freqs, reps, ts):
    """Batched long-pilot period search over detected PRNs.

    sig_r/sig_i: [S] full record (f32); cps: [n_det] segment starts;
    freqs: [n_det] coarse carriers; reps: [n_det, n_hyp, spc] int8 pilot
    replicas, one row per period hypothesis.
    One program for ALL detected PRNs; the 75-hypothesis correlation is
    a single [n_hyp, spc]·[spc] matmul per PRN (the reference
    loops hypotheses per PRN: GPS_L2C/include/acquisition.m:127-167).
    Returns the correlation magnitude of every hypothesis [n_det, n_hyp].
    """
    spc = reps.shape[2]

    def one(cp, f, rep):
        sr = jax.lax.dynamic_slice(sig_r, (cp,), (spc,))
        si = jax.lax.dynamic_slice(sig_i, (cp,), (spc,))
        t = jnp.arange(spc, dtype=jnp.float32)
        phase = (2.0 * jnp.pi * ts) * f * t
        c, sn = jnp.cos(phase), jnp.sin(phase)
        wr = sr * c + si * sn
        wi = si * c - sr * sn
        repf = rep.astype(jnp.float32)
        pr = jnp.dot(repf, wr, precision=_HIGHEST,
                     preferred_element_type=jnp.float32)
        pi = jnp.dot(repf, wi, precision=_HIGHEST,
                     preferred_element_type=jnp.float32)
        return jnp.hypot(pr, pi)

    return jax.vmap(one)(cps, freqs, reps)


@functools.partial(jax.jit, static_argnames=("envelope",))
def _fine_batched(sig_r, sig_i, cps, replicas, freqs, hyp, ts,
                  envelope: bool = False):
    """vmap of `_fine_kernel` over detected PRNs, with the per-PRN
    segment sliced ON DEVICE from the full record — one dispatch for the
    whole fine stage instead of one per PRN.

    replicas: [n_det, n_codes*spc]; freqs: [n_det, n_fine];
    hyp: [n_det, n_hyp, n_codes].  Returns powers [n_det, n_fine].
    """
    n_seg = replicas.shape[1]

    def one(cp, rep, fr, H):
        sr = jax.lax.dynamic_slice(sig_r, (cp,), (n_seg,))
        si = jax.lax.dynamic_slice(sig_i, (cp,), (n_seg,))
        return _fine_kernel(sr, si, rep, fr, H, ts, envelope=envelope)

    return jax.vmap(one)(cps, replicas, freqs, hyp)


def _bit_edge_hypotheses(n_codes: int, window: int) -> np.ndarray:
    """Sliding all-ones windows: nav-bit-edge search
    (acquisition.m:240-248)."""
    n_hyp = n_codes - window + 1
    H = np.zeros((n_hyp, n_codes), np.float32)
    for k in range(n_hyp):
        H[k, k:k + window] = 1.0
    return H


def _secondary_hypotheses(secondary: np.ndarray, n_codes: int) -> np.ndarray:
    """All circular shifts of a secondary code, tiled to n_codes
    (GPS_L5C/include/acquisition.m:241-275)."""
    m = len(secondary)
    reps = int(np.ceil(n_codes / m))
    H = np.zeros((m, n_codes), np.float32)
    for k in range(m):
        H[k] = np.tile(np.roll(secondary, k), reps)[:n_codes]
    return H


# --------------------------------------------------------------------------
# Public API
# --------------------------------------------------------------------------

def acquire(cfg, sig: SignalDef, samples: np.ndarray,
            prn_list: Optional[Sequence[int]] = None,
            fine_n_codes: Optional[int] = None) -> AcquisitionResult:
    """Run coarse+fine acquisition over ``prn_list``.

    samples: complex IF samples; needs at least
    (acq_non_coh_time + 1 + fine_n_codes) code periods.
    """
    from .resample import maybe_resample, recover
    samples, cfg, rs_info = maybe_resample(np.asarray(samples), cfg)

    prns = np.asarray(list(prn_list if prn_list is not None
                           else cfg.acq_satellite_list))
    spc = cfg.samples_per_code
    # coherent span: acq_coh_time [ms] of code periods integrated in one
    # slab; > 1 period tiles the replica (no secondary/nav wipe-off —
    # coarse-stage limitation shared with the reference)
    n_coh = max(1, int(round(cfg.acq_coh_time
                             / max(sig.code_period_ms, 1e-9))))
    spc_c = n_coh * spc
    win_len = spc_c + spc              # full-overlap lags cover [0, spc]
    # FFT length: next power of two (the fastest FFT sizes); peak search
    # stays on the reference's span —
    # 2 code periods at n_coh == 1 (acquisition.m:160-162), 1 otherwise
    search_len = 2 * spc if n_coh == 1 else spc
    nfft = 1 << (win_len - 1).bit_length()
    noncoh = cfg.acq_non_coh_time
    fs = cfg.sampling_freq
    ts = np.float32(1.0 / fs)

    # ---- build signal slabs [noncoh, win_len] (acquisition.m:175-178) -----
    assert len(samples) >= (noncoh * spc_c + spc), \
        f"need {noncoh * spc_c + spc} samples, got {len(samples)}"
    idx = (np.arange(noncoh)[:, None] * spc_c
           + np.arange(win_len)[None, :])
    win = np.asarray(samples)[idx]
    slabs_r = np.zeros((noncoh, nfft), np.float32)
    slabs_i = np.zeros((noncoh, nfft), np.float32)
    slabs_r[:, :win_len] = np.real(win)
    slabs_i[:, :win_len] = np.imag(win)

    # ---- code FFT tables [n_prn, n_comp, nfft] ----------------------------
    comps = sig.acq_code_fns()
    n_comp = len(comps)
    weights = np.asarray(sig.acq_weights[:n_comp], np.float32)
    cf_r = np.empty((len(prns), n_comp, nfft), np.float32)
    cf_i = np.empty((len(prns), n_comp, nfft), np.float32)
    for i, prn in enumerate(prns):
        for c, fn in enumerate(comps):
            table = sample_code(fn(int(prn)) if not sig.fdma
                                else fn(0), sig.elements_per_chip,
                                sig.chip_rate_hz, fs, spc)
            padded = np.zeros(nfft, np.float32)
            padded[:spc_c] = np.tile(table.astype(np.float32), n_coh)
            cfc = np.conj(np.fft.fft(padded))
            cf_r[i, c] = cfc.real
            cf_i[i, c] = cfc.imag

    # ---- Doppler grid per PRN (descending: acquisition.m:169-170) ---------
    band, step = cfg.acq_search_band, cfg.acq_search_step
    n_bins = cfg.num_freq_bins
    base = (cfg.if_freq + band - step * np.arange(n_bins)).astype(np.float32)
    excl = int(round(fs / sig.chip_rate_hz)) + 1   # ±1 chip exclusion
    coarse_freq = None
    if sig.fdma:
        # GLONASS: 'PRN' is the frequency channel K
        # (GLO_GL1/include/acquisition.m:181-182)
        offs = (prns * sig.fdma_spacing_hz).astype(np.float32)
        freqs = base[None, :] + offs[:, None]
        freqs = np.ascontiguousarray(freqs)
        peak, bin_idx, phase_idx, second, floor = _pcps_fdma_kernel(
            (jnp.asarray(slabs_r), jnp.asarray(slabs_i)),
            (jnp.asarray(cf_r[:1]), jnp.asarray(cf_i[:1])),
            jnp.asarray(weights), jnp.asarray(freqs), ts,
            n_noncoh=noncoh, n_comp=n_comp, search_len=search_len,
            excl_samples=excl, period=spc)
    elif cfg.acq_method == "circshift":
        # one signal FFT per sub-bin; Doppler via spectrum rotation
        # (GPS_L2C/include/acquisition.m:25,52-88)
        dfreq = fs / nfft
        n_sub = max(1, int(np.ceil(dfreq / step)))
        sub_step = dfreq / n_sub
        n_shift = int(round(2.0 * band / dfreq)) + 1
        f_max = cfg.if_freq + band
        sub_offsets = (f_max - sub_step * np.arange(n_sub)
                       ).astype(np.float32)
        (peak, m_idx, sub_idx, phase_idx, second,
         floor) = _pcps_circshift_kernel(
            (jnp.asarray(slabs_r), jnp.asarray(slabs_i)),
            (jnp.asarray(cf_r), jnp.asarray(cf_i)),
            jnp.asarray(weights), jnp.asarray(sub_offsets), ts,
            n_shift=n_shift, n_comp=n_comp, search_len=search_len,
            excl_samples=excl, period=spc)
        # carrFreq = f_max − m·Δf − j·sub_step (acquisition.m:119)
        coarse_freq = (f_max - np.asarray(m_idx) * dfreq
                       - np.asarray(sub_idx) * sub_step)
        bin_idx = np.zeros(len(prns), np.int64)
    else:
        freqs = np.broadcast_to(base, (len(prns), n_bins))
        peak, bin_idx, phase_idx, second, floor = _pcps_cdma_kernel(
            (jnp.asarray(slabs_r), jnp.asarray(slabs_i)),
            (jnp.asarray(cf_r), jnp.asarray(cf_i)),
            jnp.asarray(weights), jnp.asarray(base), ts,
            n_noncoh=noncoh, n_comp=n_comp, search_len=search_len,
            excl_samples=excl, period=spc)
    peak = np.asarray(peak)
    bin_idx = np.asarray(bin_idx)
    phase_idx = np.asarray(phase_idx)
    second = np.asarray(second)

    if cfg.acq_metric == "second_peak":
        # peak / second-peak ratio (GPS_L2C/include/acquisition.m:90-112)
        metric = peak / np.maximum(second, 1e-12)
    else:
        # Noise-floor-referenced GLRT: the peak is normalized by the
        # MEASURED mean of its own weighted envelope surface.  Under
        # noise a single-component surface has mean
        # sqrt(pi)/2 * sigma * sqrt(spc) * noncoh, so scaling by
        # sqrt(pi)/2 makes this numerically match the reference's
        # peak/sigma/noncoh statistic (acquisition.m:150-151,200) for
        # one component — the preset thresholds keep their meaning —
        # while weighted multi-component surfaces (GAL_E1C
        # acquisition.m:195, BDS/B1C acquisition.m:213-214) are
        # calibrated by construction: the floor already carries the
        # component count, the weights and the integration depth, so
        # the noise-only metric distribution is weight-invariant
        # (pinned by tests/test_acq_false_alarm.py).
        metric = (np.sqrt(np.pi) / 2.0) * peak \
            / np.maximum(np.asarray(floor), 1e-12)
    detected = metric > cfg.acq_threshold

    if coarse_freq is None:
        coarse_freq = freqs[np.arange(len(prns)), bin_idx]

    # ---- fine frequency stage (acquisition.m:203-260) ---------------------
    # Strategy per signal class (generalizing the per-receiver variants):
    #   * pilot with a short secondary (≤100 chips): wipe the pilot code
    #     and try every secondary-code phase (L5C NH20, E5a CS100, E1C
    #     CS25 — GPS_L5C/include/acquisition.m:241-275,
    #     GAL_E5a/include/acquisition.m:229-253)
    #   * data-only with NH secondary: same over the data component
    #   * plain data (L1CA): sliding nav-bit-edge windows
    #     (acquisition.m:240-248)
    #   * long secondary (B1C 1800): data-sign-insensitive envelope fine
    #     search (BDS/B1C/include/acquisition.m:262-263 CW-style)
    n_codes = fine_n_codes or cfg.fine_n_codes or max(
        int(round(40.0 / max(sig.code_period_ms, 1e-9))), 4)
    # clamp to the record so a short acquisition slice degrades the fine
    # resolution instead of crashing (a code phase can sit anywhere in
    # the first period, so n_codes + 1 periods must fit)
    n_codes_max = len(samples) // spc - 1
    if n_codes > n_codes_max:
        warnings.warn(
            f"fine stage clamped from {n_codes} to {n_codes_max} code "
            f"periods by the record length ({len(samples)} samples)")
        n_codes = max(n_codes_max, 1)
    carr_freq = np.zeros(len(prns))
    code_phase = np.zeros(len(prns), np.int64)
    fine_step = cfg.fine_search_step
    n_fine = int(round(cfg.acq_search_step / fine_step)) + 1

    nav_codes = max(int(round(sig.nav_symbol_ms / sig.code_period_ms)), 1)

    def fine_setup(prn: int):
        """(code_fn, hypotheses H or None=envelope) for this PRN."""
        psec = sig.pilot_secondary(int(prn)) \
            if sig.pilot_secondary is not None else None
        if sig.pilot_code is not None and psec is None:
            # pilot with no secondary modulation: fully coherent
            # (L2C CL, B2a pilot).  NOTE: for L2C the CL phase within its
            # 1.5 s period is resolved separately (CL-phase search,
            # GPS_L2C/include/acquisition.m:127-167); in this fine stage
            # the replica starts at phase 0.
            return sig.pilot_code, np.ones((1, n_codes), np.float32)
        if psec is not None and len(psec) <= 100:
            return sig.pilot_code, _secondary_hypotheses(psec, n_codes)
        if sig.data_secondary is not None \
                and len(sig.data_secondary) <= 100:
            return sig.data_code, _secondary_hypotheses(
                sig.data_secondary, n_codes)
        if nav_codes > 1:
            return sig.data_code, _bit_edge_hypotheses(
                n_codes, min(nav_codes, max(n_codes // 2, 1)))
        if nav_codes == 1 and psec is None:
            # symbol per code period, no pilot: coherent over one code
            return sig.data_code, np.eye(n_codes, dtype=np.float32)
        return sig.data_code, None     # envelope mode

    # The fine stage is BATCHED over detected PRNs: segments are sliced
    # on device, the long-pilot (CL) phase search is one matmul over all
    # hypotheses, and one vmapped fine kernel covers every PRN — no
    # per-PRN dispatch (the reference loops per PRN,
    # acquisition.m:203-260).
    pilot_phase = np.zeros(len(prns), np.int64)
    det_idx = [i for i in range(len(prns)) if detected[i]]
    if det_idx:
        n_det = len(det_idx)
        # code-aligned segment starts, stepped back whole periods when
        # the fine window would run off the record
        cps = np.empty(n_det, np.int64)
        for j, i in enumerate(det_idx):
            cp = int(phase_idx[i])
            need = cp + n_codes * spc
            if need > len(samples):
                back = int(np.ceil((need - len(samples)) / spc)) * spc
                cp = cp - back if cp >= back else cp % spc
            cps[j] = cp
        assert cps.min() >= 0 \
            and int((cps + n_codes * spc).max()) <= len(samples), \
            "fine stage needs at least (fine_n_codes + 1) code periods"
        seg_all = np.asarray(samples)
        seg_r = np.real(seg_all).astype(np.float32)
        seg_i = np.imag(seg_all).astype(np.float32)
        cfreqs = coarse_freq[det_idx].astype(np.float32)

        # ---- long-pilot phase search (L2C CL, acquisition.m:127-167) ------
        nhyp = sig.pilot_phase_hypotheses
        if nhyp > 1 and sig.pilot_code is not None:
            epc_ = sig.elements_per_chip
            n_elem_period = sig.code_length_chips * epc_
            eidx = np.floor(np.arange(spc) * (sig.chip_rate_hz / fs)
                            * epc_).astype(np.int64)
            reps = np.empty((n_det, nhyp, spc), np.int8)
            for j, i in enumerate(det_idx):
                pilot_elems = sig.pilot_code(int(prns[i]))
                shift = (eidx[None, :]
                         + (np.arange(nhyp) * n_elem_period)[:, None]
                         ) % len(pilot_elems)
                reps[j] = pilot_elems[shift]
            ph_seg = np.argmax(np.asarray(_pilot_phase_corr(
                jnp.asarray(seg_r), jnp.asarray(seg_i),
                jnp.asarray(cps), jnp.asarray(cfreqs),
                jnp.asarray(reps), ts)), axis=1)
            for j, i in enumerate(det_idx):
                # the hypothesis indexes the segment at cps[j]; convert
                # to the pilot period at phase_idx[i] (tracking start)
                back_periods = (int(phase_idx[i]) - int(cps[j])) // spc
                pilot_phase[i] = (int(ph_seg[j]) + back_periods) % nhyp

        # ---- batched fine-frequency kernel --------------------------------
        replicas = np.empty((n_det, n_codes * spc), np.float32)
        Hs = None
        envelope = False
        for j, i in enumerate(det_idx):
            code_fn, H = fine_setup(int(prns[i]))
            elems = code_fn(0 if sig.fdma else int(prns[i]))
            # pilot-based fine on a long pilot starts at the resolved
            # phase
            # (the replica must match the SEGMENT at cps[j], not the
            # tracking start at phase_idx[i])
            fine_offset_chips = 0.0
            if nhyp > 1 and code_fn is sig.pilot_code:
                fine_offset_chips = float(int(ph_seg[j])
                                          * sig.code_length_chips)
            replicas[j] = sample_code(
                elems, sig.elements_per_chip, sig.chip_rate_hz, fs,
                n_codes * spc, code_phase_chips=fine_offset_chips
                ).astype(np.float32)
            envelope = H is None
            if Hs is None:
                Hs = np.empty((n_det,) + (np.ones((1, n_codes))
                                          if envelope else H).shape,
                              np.float32)
            Hs[j] = np.ones((1, n_codes), np.float32) if envelope else H
        fine_freqs = (cfreqs[:, None] + cfg.acq_search_step / 2
                      - fine_step * np.arange(n_fine)[None, :]
                      ).astype(np.float32)
        powers = np.asarray(_fine_batched(
            jnp.asarray(seg_r), jnp.asarray(seg_i), jnp.asarray(cps),
            jnp.asarray(replicas), jnp.asarray(fine_freqs),
            jnp.asarray(Hs), ts, envelope=envelope))
        for j, i in enumerate(det_idx):
            carr_freq[i] = fine_freqs[j, int(np.argmax(powers[j]))]
            if carr_freq[i] == 0.0:
                carr_freq[i] = 1.0   # acquisition.m:257-260
            code_phase[i] = int(phase_idx[i])
            # downsampling recovery (acquisition.m:262-282)
            code_phase[i], carr_freq[i] = recover(code_phase[i],
                                                  carr_freq[i], rs_info)

    return AcquisitionResult(
        prns=prns, carr_freq=carr_freq, code_phase=code_phase,
        peak_metric=np.asarray(metric), detected=np.asarray(detected),
        coarse_freq=np.asarray(coarse_freq), pilot_phase=pilot_phase)
