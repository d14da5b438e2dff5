"""Plain float64 references of the acquisition stages that end in a
matrix product: the fine-frequency search (pcps._fine_kernel,
acquisition.m:203-260) and the long-pilot period search
(pcps._pilot_phase_corr, GPS_L2C/include/acquisition.m:127-167).

Each returns, beside its result, the norm of the data operand of the
product, the scale of ``tracking.reference.parity_error``: an f32
product is off by a few 1e-7 of it, a TF32 product by about 2.8e-4.
"""

from __future__ import annotations

import numpy as np


def _wipe(sig_r, sig_i, f, ts, n):
    """(sig_r + j sig_i) · e^{-j2π f ts n} in float64."""
    s = np.asarray(sig_r, np.float64) + 1j * np.asarray(sig_i, np.float64)
    return s * np.exp(-2j * np.pi * float(ts) * float(f) * n)


def fine_powers_f64(sig_r, sig_i, code_replica, freqs, hyp, ts,
                    envelope: bool = False):
    """pcps._fine_kernel in float64: powers [n_fine] and the norm of the
    per-code sums ||s_f||_2 [n_fine] that the hypothesis product
    combines."""
    hyp = np.asarray(hyp, np.float64)
    n_codes = hyp.shape[1]
    n = np.arange(len(sig_r), dtype=np.float64)
    rep = np.asarray(code_replica, np.float64)
    powers, norms = [], []
    for f in np.asarray(freqs):
        w = _wipe(sig_r, sig_i, f, ts, n) * rep
        s = w.reshape(n_codes, -1).sum(axis=1)
        norms.append(np.sqrt((np.abs(s) ** 2).sum()))
        powers.append(np.abs(s).sum() if envelope
                      else np.abs(hyp @ s).max())
    return np.asarray(powers), np.asarray(norms)


def pilot_phase_corr_f64(sig_r, sig_i, cps, freqs, reps, ts):
    """pcps._pilot_phase_corr in float64: magnitudes [n_det, n_hyp] and
    the norm of each PRN's wiped segment ||w||_2 [n_det]."""
    reps = np.asarray(reps, np.float64)
    spc = reps.shape[2]
    n = np.arange(spc, dtype=np.float64)
    mags, norms = [], []
    for cp, f, rep in zip(np.asarray(cps), np.asarray(freqs), reps):
        w = _wipe(sig_r[cp:cp + spc], sig_i[cp:cp + spc], f, ts, n)
        mags.append(np.abs(rep @ w))
        norms.append(np.sqrt((np.abs(w) ** 2).sum()))
    return np.asarray(mags), np.asarray(norms)


def fine_inputs(fs: float, n_codes: int = 40, n_fine: int = 21,
                seed: int = 0):
    """Inputs of pcps._fine_kernel for one L1 C/A PRN at sampling rate
    ``fs``: a code-modulated tone in noise near 0 Hz, the
    reference's 25 Hz fine grid and its 20 ms bit-edge hypotheses
    (acquisition.m:203-260).  Returns (sig_r, sig_i, replica, freqs,
    hyp, ts) as float32 numpy arrays (ts a float32 scalar)."""
    from ..signals.codes import gps
    from ..signals.defs import sample_code
    from .pcps import _bit_edge_hypotheses

    spc = int(round(fs * 1e-3))
    rng = np.random.default_rng(seed)
    rep = np.tile(sample_code(gps.l1ca(1), 1, 1.023e6, fs, spc),
                  n_codes).astype(np.float32)
    ts = np.float32(1.0 / fs)
    n = np.arange(n_codes * spc)
    sig = (0.5 * rep * np.exp(2j * np.pi * 110.0 * n / fs)
           + 4.0 * (rng.standard_normal(n.size)
                    + 1j * rng.standard_normal(n.size)))
    freqs = (110.0 + 250.0 - 25.0 * np.arange(n_fine)).astype(np.float32)
    hyp = _bit_edge_hypotheses(n_codes, 20)
    return (sig.real.astype(np.float32), sig.imag.astype(np.float32), rep,
            freqs, hyp, ts)


def pilot_inputs(fs: float, n_det: int = 4, n_hyp: int = 75,
                 period_ms: float = 20.0, seed: int = 0):
    """Inputs of pcps._pilot_phase_corr at sampling rate ``fs``: n_det
    PRNs with ``n_hyp`` random ±1 replicas of one ``period_ms`` code
    period each (the L2C CM period and CL hypothesis count,
    GPS_L2C/include/acquisition.m:127-167), one of them planted weakly
    in the noise record (the magnitudes stay noise-like, the regime in
    which a product's input rounding shows).  Returns (sig_r, sig_i, cps,
    freqs, reps, ts)."""
    spc = int(round(fs * period_ms * 1e-3))
    rng = np.random.default_rng(seed)
    reps = (2 * rng.integers(0, 2, (n_det, n_hyp, spc)) - 1).astype(
        np.int8)
    ts = np.float32(1.0 / fs)
    cps = np.arange(n_det) * (spc // 3)
    freqs = np.linspace(-200.0, 200.0, n_det).astype(np.float32)
    n_rec = int(cps[-1]) + spc
    sig = 4.0 * (rng.standard_normal(n_rec)
                 + 1j * rng.standard_normal(n_rec))
    t = np.arange(spc)
    for d in range(n_det):
        sig[cps[d]:cps[d] + spc] += (0.02 * reps[d, 7 * d % n_hyp]
                                     * np.exp(2j * np.pi * float(freqs[d])
                                              * t / fs))
    return (sig.real.astype(np.float32), sig.imag.astype(np.float32), cps,
            freqs, reps, ts)
