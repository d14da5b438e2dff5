"""Vectorized channel-bank tracking engine.

Reference semantics: GPS/GPS_L1CA/include/tracking.m — per-channel,
per-code-period closed loop: variable-size sample block (tracking.m:219-222),
E/P/L code lookup by ceil-index (:252-270), carrier NCO with residual phase
(:280-287), six correlator sums (:295-300), atan Costas PLL + E−L envelope
DLL with 2nd-order loop filters (:305-335).

Accelerator redesign (not a port):
  * the sequential for-loop over channels × milliseconds becomes ONE jitted
    `lax.scan` over epochs over the whole channel bank — a superblock of
    IF samples is resident on device as raw int8 and each channel reads
    its own window per epoch;
  * the variable `blksize` is normalized to a fixed padded block with a
    validity mask; loop state (remCodePhase/remCarrPhase/NCOs) is carried in
    float64 scalars while the per-sample arrays stay float32;
  * one epoch == one primary-code period for every signal (all reference
    receivers integrate over exactly one code period: 1 ms L1CA/L5/E5,
    4 ms E1C, 10 ms B1C, 20 ms L2C);
  * data+pilot channels add three pilot correlators with a π/2-rotated
    carrier and averaged discriminators (tracking.m pilot paths of
    L5C/E5a/E1C, survey §2.3);
  * the per-sample correlator work has two implementations of the same
    sums: the fused GPU kernel (ops/correlator.py), chosen on GPU
    backends, and a vmapped XLA epoch everywhere else.  Both are compared
    with the float64 reference of tracking/reference.py.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..signals.defs import SignalDef
from .loop_filters import calc_loop_coef
from .cno import cno_vsm

_TWO_PI = 2.0 * np.pi


@dataclass(frozen=True)
class TrackParams:
    """Static (hashable) tracking parameters — jit specialization key."""
    fs: float
    code_len: int               # chips per code period
    elements_per_chip: int
    code_freq_basis: float
    blk: int                    # padded fixed block size [samples]
    spacing: float              # E-L correlator spacing [chips]
    tau1_code: float
    tau2_code: float
    tau1_carr: float
    tau2_carr: float
    pdi: float                  # integration time [s]
    has_pilot: bool = False
    data_weight: float = 0.5    # data/pilot PLL combining
    pilot_weight: float = 0.5   # (B1C: 11/40, 29/40 — NB_tracking.m:344)
    dll_data_weight: float = 0.5    # DLL combining (WB: factor/(1-factor),
    dll_pilot_weight: float = 0.5   # WB_tracking.m:300-315)
    pilot_epc: int = 0          # pilot table elements/chip (0 = same as
                                # elements_per_chip; WB BOC(6,1): 12)
    dll_scale: float = 1.0      # discriminator scale (WB: 1-spacing)
    fast_code: bool = True      # sliced precomputed replica (fast path)
                                # instead of per-epoch gather
    up_margin: int = 384        # replica table margin [samples]
    k_spacing: int = 1          # E-L spacing [samples] (static: round(
                                # spacing*fs/chip_rate); loop-induced step
                                # changes never move it by half a sample)
    pll_order: int = 2
    pf1: float = 0.0            # 3rd-order PLL gains
    pf2: float = 0.0            # (NB_tracking.m:347-349)
    pf3: float = 0.0
    use_pallas: bool = False    # fused correlator kernel (GPU only)
    pallas_interpret: bool = False   # interpret the kernel (CPU tests)
    pilot_rot: int = 1          # pilot carrier phase in quarter turns vs
                                # data: 1 = +Q (L5/E1/E5 quadrature
                                # pilots), 0 = +I (L2C time-multiplexed
                                # CL, GPS_L2C/include/tracking.m:317-324),
                                # 2 = -I (B1C QMBOC BOC(6,1),
                                # WB_tracking.m:364-369), 3 = -Q
    pilot_period_mod: int = 0   # long pilot spanning N code periods: the
                                # pilot replica advances one period per
                                # epoch, rolling at N (L2C CL: 75,
                                # GPS_L2C/include/tracking.m:363-364)
    has_pilot2: bool = False    # composite dual pilot bank: B1C WB QMBOC
                                # tracks pilot BOC(1,1) AND BOC(6,1)
                                # simultaneously (WB_tracking.m:292-315)
    pilot2_rot: int = 2         # bank-2 quarter-turn rotation
    pilot2_epc: int = 0         # bank-2 elements/chip (BOC(6,1): 12)
    pilot_w1: float = 1.0       # composite amplitude weights applied to
    pilot_w2: float = 0.0       # the ROTATED bank sums — the reference's
                                # -sqrt(4/33)*p61 + sqrt(29/33)*(-j*p11)
                                # combine (WB_tracking.m:364-369)
    interp_taps: bool = True    # sub-sample replica interpolation; False
                                # = nearest-sample taps (the reference's
                                # ceil-index fidelity, tracking.m:252-270)


class ChannelState(NamedTuple):
    """Per-channel loop state (the carry of tracking.m:160-181), [C]."""
    carr_freq: jnp.ndarray          # f64 [Hz]
    carr_freq_basis: jnp.ndarray    # f64 [Hz]
    code_freq: jnp.ndarray          # f64 [Hz]
    code_freq_basis: jnp.ndarray    # f64 [Hz] (Doppler-aided center,
                                    # preRun.m:71-73 of the wideband rx)
    rem_code_phase: jnp.ndarray     # f64 [chips]
    rem_carr_phase: jnp.ndarray     # f64 [rad]
    carr_nco: jnp.ndarray           # f64
    carr_err: jnp.ndarray           # f64
    code_nco: jnp.ndarray           # f64
    code_err: jnp.ndarray           # f64
    d_carr: jnp.ndarray             # f64 — 3rd-order PLL integrators
    d2_carr: jnp.ndarray            # f64   (NB_tracking.m:347-349)
    abs_sample: jnp.ndarray         # i64 — sample index of epoch start
    pilot_period: jnp.ndarray       # i32 — long-pilot period counter
                                    # (L2C CLCodePhase, tracking.m:363-364)
    active: jnp.ndarray             # bool — channel lifecycle: False stops
                                    # updates (out-of-data exit of
                                    # tracking.m:241-245 / loss of lock)


class TrackOutputs(NamedTuple):
    """Per-epoch outputs [n_epochs, C] (trackResults fields,
    tracking.m:45-83)."""
    i_e: jnp.ndarray
    q_e: jnp.ndarray
    i_p: jnp.ndarray
    q_p: jnp.ndarray
    i_l: jnp.ndarray
    q_l: jnp.ndarray
    pilot_ip: jnp.ndarray
    pilot_qp: jnp.ndarray
    carr_freq: jnp.ndarray
    code_freq: jnp.ndarray
    dll_discr: jnp.ndarray
    dll_filt: jnp.ndarray
    pll_discr: jnp.ndarray
    pll_filt: jnp.ndarray
    rem_code_phase: jnp.ndarray
    rem_carr_phase: jnp.ndarray
    abs_sample: jnp.ndarray
    blksize: jnp.ndarray


def init_channel_state(channels: Sequence, code_freq_basis: float,
                       dopplers=None, carrier_freq_hz: float = 0.0
                       ) -> ChannelState:
    """channels: iterable of (prn, acquired_carr_freq, code_phase_samples
    [, pilot_period]).

    Mirrors tracking.m:160-181 initialization; abs_sample starts at the
    acquired code phase (tracking.m:145-153 fseek).  When ``dopplers``
    (acquired carrier Doppler per channel [Hz]) and ``carrier_freq_hz``
    are given, the per-channel code-NCO center is Doppler-aided:
    basis·(1 + doppler/f_carrier) — the wideband receivers' init
    (GAL_E5a/include/preRun.m:71-73).  The optional 4th element is the
    acquired long-pilot period index (L2C CLCodePhase,
    GPS_L2C/include/tracking.m:161-163).
    """
    c = len(channels)
    carr = np.asarray([ch[1] for ch in channels], np.float64)
    phase = np.asarray([ch[2] for ch in channels], np.int64)
    pper = np.asarray([ch[3] if len(ch) > 3 else 0 for ch in channels],
                      np.int32)
    z = np.zeros(c, np.float64)
    basis = np.full(c, code_freq_basis, np.float64)
    if dopplers is not None and carrier_freq_hz > 0:
        basis = basis * (1.0 + np.asarray(dopplers, np.float64)
                         / carrier_freq_hz)
    return ChannelState(
        carr_freq=jnp.asarray(carr),
        carr_freq_basis=jnp.asarray(carr),
        code_freq=jnp.asarray(basis.copy()),
        code_freq_basis=jnp.asarray(basis),
        rem_code_phase=jnp.asarray(z),
        rem_carr_phase=jnp.asarray(z),
        carr_nco=jnp.asarray(z), carr_err=jnp.asarray(z),
        code_nco=jnp.asarray(z), code_err=jnp.asarray(z),
        d_carr=jnp.asarray(z), d2_carr=jnp.asarray(z),
        abs_sample=jnp.asarray(phase),
        pilot_period=jnp.asarray(pper),
        active=jnp.ones(c, bool))


def _pilot_rotate(bb_i, bb_q, rot: int):
    """j^rot · (bb_i + j·bb_q) as an (i, q) pair (TrackParams.pilot_rot)."""
    if rot == 0:
        return bb_i, bb_q
    if rot == 1:
        return -bb_q, bb_i
    if rot == 2:
        return -bb_i, -bb_q
    return bb_q, -bb_i


def _combine_pilot(ps, ps2, p: TrackParams):
    """Raw pilot sums [..., 6] (iE qE iP qP iL qL against the unrotated
    baseband) -> the pilot correlators [..., 6].  The quarter-turn
    carrier rotation (GPS_L5C/include/tracking.m:334-345) commutes with
    the real bilinear correlation, so it is applied to the sums; the
    composite QMBOC pilot rotates both banks onto the in-phase axis and
    amplitude-combines them (WB_tracking.m:364-369):
    -sqrt(4/33)·p61 - j·sqrt(29/33)·p11 with p11 on +Q (rot 3) and p61 on
    -I (rot 2)."""
    rots = [_pilot_rotate(ps[..., 2 * j], ps[..., 2 * j + 1], p.pilot_rot)
            for j in range(3)]
    if ps2 is not None:
        rots2 = [_pilot_rotate(ps2[..., 2 * j], ps2[..., 2 * j + 1],
                               p.pilot2_rot) for j in range(3)]
        w1, w2 = jnp.float32(p.pilot_w1), jnp.float32(p.pilot_w2)
        rots = [(w1 * a_i + w2 * b_i, w1 * a_q + w2 * b_q)
                for (a_i, a_q), (b_i, b_q) in zip(rots, rots2)]
    return jnp.stack([x for pair in rots for x in pair], axis=-1)


def _block_size(st, p: TrackParams):
    """(code_phase_step [chips/sample], blksize) of the next epoch
    (tracking.m:219-222), elementwise over a state slice or [C] bank."""
    code_phase_step = st.code_freq / p.fs          # f64 chips/sample
    blksize = jnp.ceil((p.code_len - st.rem_code_phase)
                       / code_phase_step).astype(jnp.int32)
    return code_phase_step, jnp.minimum(blksize, p.blk)


def _replica_windows(st, p: TrackParams):
    """Fast-path replica windows of the next epoch, elementwise over a
    state slice or [C] bank: (start, alpha) of the data table and
    (pstart, palpha) of the pilot table — the table index of the early
    tap's first sample and the sub-sample interpolation fraction.

    The replica is pre-sampled once per run at the Doppler-aided code
    rate; per-epoch fractional code phase is realized by sub-sample
    interpolation.  blksize uses ceil, so rem_code_phase stays in
    [0, code_phase_step) and the integer sample shift is ~always 0.  The
    f64 ``rem`` carry stays exact; only intra-epoch chip-boundary
    placement is quantized to the sample grid (sub-0.01-chip,
    zero-mean).  A long pilot (L2C CL) advances its window by the current
    pilot period within the full-period table; its chip → index map is a
    property of the TABLE, so it divides by the BUILD-time step
    (code_freq_basis), not the live DLL rate — at period P the difference
    is amplified by P·code_len chips and would walk the replica off by
    whole chips within a few periods."""
    shift_f = st.rem_code_phase / (st.code_freq / p.fs)
    alpha = (shift_f - jnp.floor(shift_f)).astype(jnp.float32)
    start = p.up_margin + jnp.floor(shift_f).astype(jnp.int32) \
        - p.k_spacing
    if not (p.has_pilot and p.pilot_period_mod > 1):
        return start, alpha, start, alpha
    pshift_f = ((st.rem_code_phase
                 + st.pilot_period.astype(jnp.float64) * p.code_len)
                / (st.code_freq_basis / p.fs))
    palpha = (pshift_f - jnp.floor(pshift_f)).astype(jnp.float32)
    pstart = p.up_margin + jnp.floor(pshift_f).astype(jnp.int32) \
        - p.k_spacing
    return start, alpha, pstart, palpha


def _correlate_one_channel(samples_iq, sb_start, code_table, pilot_table,
                           st, p: TrackParams):
    """Correlator sums of one epoch (one code period) for one channel —
    the XLA epoch, vmapped over the bank.

    samples_iq: [S] uint16 packed, or [2S] int8/int16 interleaved I/Q
    (device-resident superblock)
    code_table/pilot_table: fast path — [blk + 2*up_margin] int8
    pre-sampled replica (chip phase (m - up_margin)*step at index m);
    exact path — [E] int8 code elements
    st: per-channel scalar slice of ChannelState
    Returns (blksize, code_phase_step, inc, sums [12]) with sums
    iE qE iP qP iL qL piE pqE piP pqP piL pqL (pilot zeros without one).
    """
    epc = p.elements_per_chip
    n_elem = p.code_len * epc

    code_phase_step, blksize = _block_size(st, p)

    # ---- fetch raw samples (tracking.m:226-236) ---------------------------
    # uint16 marks the PACKED layout: one complex sample per element,
    # int8 I in the low byte, int8 Q in the high byte (the free host-side
    # numpy .view(uint16) of interleaved schar I/Q).  int8/int16 arrays
    # are interleaved I/Q streams of that scalar type (cfg.data_type,
    # initSettings.m:61).
    if samples_iq.dtype == jnp.uint16:
        raw16 = jax.lax.dynamic_slice(
            samples_iq, (st.abs_sample - sb_start,), (p.blk,))
        sig_i = raw16.astype(jnp.int8).astype(jnp.float32)
        sig_q = (raw16 >> 8).astype(jnp.int8).astype(jnp.float32)
    else:
        off = 2 * (st.abs_sample - sb_start)
        raw = jax.lax.dynamic_slice(samples_iq, (off,), (2 * p.blk,))
        sig_i = raw[0::2].astype(jnp.float32)
        sig_q = raw[1::2].astype(jnp.float32)

    n = jnp.arange(p.blk, dtype=jnp.float32)
    mask = n < blksize.astype(jnp.float32)

    # ---- E/P/L code replicas ----------------------------------------------
    tcode = (jnp.float32(st.rem_code_phase)
             + n * jnp.float32(code_phase_step))

    if p.fast_code:
        # fast path (_replica_windows): the E/P/L taps reduce to ONE
        # dynamic window slice plus STATIC sub-slices XLA can fuse as
        # views (6 dynamic slices would each be materialized)
        k = p.k_spacing
        start, alpha, pstart, palpha = _replica_windows(st, p)
        win = jax.lax.dynamic_slice(code_table, (start,),
                                    (p.blk + 2 * k + 1,))

        def repl(d):
            a = jax.lax.slice(win, (d,), (d + p.blk,)).astype(jnp.float32)
            if not p.interp_taps:
                return a                 # nearest-sample (reference parity)
            b = jax.lax.slice(win, (d + 1,),
                              (d + 1 + p.blk,)).astype(jnp.float32)
            return a + alpha * (b - a)   # sub-sample phase interpolation

        early = repl(0)
        prompt = repl(k)
        late = repl(2 * k)
    else:
        def chips(offset_chips):
            idx = jnp.ceil((tcode + offset_chips) * epc).astype(
                jnp.int32) - 1
            return code_table[jnp.mod(idx, n_elem)].astype(jnp.float32)

        early = chips(jnp.float32(-p.spacing))
        prompt = chips(jnp.float32(0.0))
        late = chips(jnp.float32(p.spacing))

    # ---- carrier wipe-off (tracking.m:280-291) ----------------------------
    # Phase is carried in f64 SCALARS; the per-sample ramp splits the
    # index as n = 256*a + b and evaluates the two phase terms in f64 on
    # their short grids (blk/256 and 256 points), reduced mod 1 before
    # the f32 cast, so each sample's phase is exact to f32 rounding
    # (~1e-7 cycles) at any epoch length.
    inc = _TWO_PI * st.carr_freq / p.fs            # f64 rad/sample
    inc_c = st.carr_freq / p.fs                    # f64 cycles/sample
    a = jnp.arange(-(-p.blk // 256), dtype=jnp.float64)
    b = jnp.arange(256, dtype=jnp.float64)
    hi = jnp.mod(st.rem_carr_phase / _TWO_PI + inc_c * 256.0 * a,
                 1.0).astype(jnp.float32)
    lo = jnp.mod(inc_c * b, 1.0).astype(jnp.float32)
    cyc = (hi[:, None] + lo[None, :]).reshape(-1)[:p.blk]
    phase = (cyc - jnp.floor(cyc)) * jnp.float32(_TWO_PI)
    cosw = jnp.cos(phase)
    sinw = jnp.sin(phase)
    # exp(-j·phase) · (I + jQ)
    bb_i = (sig_i * cosw + sig_q * sinw) * mask
    bb_q = (sig_q * cosw - sig_i * sinw) * mask

    # ---- six correlators (tracking.m:295-300) -----------------------------
    # multiply-and-sum in f32 (a matrix product here could run in TF32)
    def corr(codes):                               # [3, blk] -> [6]
        return jnp.stack([jnp.sum(codes * bb_i, axis=1),
                          jnp.sum(codes * bb_q, axis=1)], axis=1).reshape(6)

    sums = corr(jnp.stack([early, prompt, late]))

    if p.has_pilot:
        # Pilot correlators.  The raw sums are taken against the SAME
        # baseband as the data bank and the quarter-turn carrier rotation
        # is applied to the SUMS (_combine_pilot), saving two [blk]
        # vectors per epoch.  The pilot table may use a finer
        # element grid (WB QMBOC BOC(6,1): 12 elements/chip,
        # WB_tracking.m:176-188).
        if p.fast_code:
            def pbank_fast(tab):
                pwin = jax.lax.dynamic_slice(tab, (pstart,),
                                             (p.blk + 2 * k + 1,))

                def prepl(d):
                    a = jax.lax.slice(pwin, (d,),
                                      (d + p.blk,)).astype(jnp.float32)
                    if not p.interp_taps:
                        return a
                    b = jax.lax.slice(pwin, (d + 1,),
                                      (d + 1 + p.blk,)).astype(
                                          jnp.float32)
                    return a + palpha * (b - a)
                return jnp.stack([prepl(0), prepl(k), prepl(2 * k)])

            pcodes = pbank_fast(pilot_table[0] if p.has_pilot2
                                else pilot_table)
            pcodes2 = pbank_fast(pilot_table[1]) if p.has_pilot2 else None
        else:
            pepc = p.pilot_epc or epc
            pn_elem = p.code_len * pepc * max(p.pilot_period_mod, 1)
            poff_elem = st.pilot_period * (p.code_len * pepc) \
                if p.pilot_period_mod > 1 else 0

            def pbank_gather(pepc_b, base, n_el, off):
                def pchips(offset_chips):
                    idx = jnp.ceil((tcode + offset_chips)
                                   * pepc_b).astype(jnp.int32) - 1 + off
                    return pilot_table[base + jnp.mod(idx, n_el)].astype(
                        jnp.float32)
                return jnp.stack([pchips(jnp.float32(-p.spacing)),
                                  pchips(jnp.float32(0.0)),
                                  pchips(jnp.float32(p.spacing))])

            pcodes = pbank_gather(pepc, 0, pn_elem, poff_elem)
            pcodes2 = None
            if p.has_pilot2:
                # dual-bank tables are concatenated along the element
                # axis: bank 2 starts after bank 1's elements
                pcodes2 = pbank_gather(p.pilot2_epc, pn_elem,
                                       p.code_len * p.pilot2_epc, 0)

        psums = _combine_pilot(
            corr(pcodes), corr(pcodes2) if p.has_pilot2 else None, p)
    else:
        psums = jnp.zeros(6, jnp.float32)
    return (blksize, code_phase_step, inc,
            jnp.concatenate([sums, psums]))


def _close_epoch(st, p: TrackParams, blksize, code_phase_step, inc,
                 end_sample,
                 i_e, q_e, i_p, q_p, i_l, q_l,
                 pi_e, pq_e, pi_p, pq_p, pi_l, pq_l):
    """Discriminators, loop filters and state/output packing for the
    whole bank ([C] vectors, whichever path produced the correlator
    sums); all ops are elementwise."""
    # channel lifecycle: an epoch is valid only while the channel is
    # active and its window stays inside the record — the out-of-data
    # exit of tracking.m:241-245, made per-channel
    valid = jnp.logical_and(st.active,
                            st.abs_sample + p.blk <= end_sample)
    # ---- phase carries (tracking.m:273,283) -------------------------------
    bsf = blksize.astype(jnp.float64)
    rem_code = (st.rem_code_phase + bsf * code_phase_step) - p.code_len
    rem_carr = jnp.mod(st.rem_carr_phase + inc * bsf, _TWO_PI)

    # ---- PLL: atan Costas + 2nd-order filter (tracking.m:305-317) ---------
    eps = jnp.float32(1e-12)
    carr_err = jnp.arctan(q_p / (i_p + eps)) / _TWO_PI
    if p.has_pilot:
        pcarr = jnp.arctan(pq_p / (pi_p + eps)) / _TWO_PI
        carr_err = p.data_weight * carr_err + p.pilot_weight * pcarr
    carr_err = carr_err.astype(jnp.float64)
    if p.pll_order == 3:
        # 3rd-order loop integrators (NB_tracking.m:347-349)
        d2_carr = st.d2_carr + carr_err * p.pf3
        d_carr = d2_carr + carr_err * p.pf2 + st.d_carr
        carr_nco = d_carr + carr_err * p.pf1
    else:
        d_carr, d2_carr = st.d_carr, st.d2_carr
        carr_nco = (st.carr_nco
                    + (p.tau2_carr / p.tau1_carr)
                    * (carr_err - st.carr_err)
                    + carr_err * (p.pdi / p.tau1_carr))
    carr_freq = st.carr_freq_basis + carr_nco

    # ---- DLL: E−L envelope + 2nd-order filter (tracking.m:322-335) --------
    env_e = jnp.sqrt(i_e * i_e + q_e * q_e)
    env_l = jnp.sqrt(i_l * i_l + q_l * q_l)
    if p.has_pilot:
        # per-channel discriminators combined with DLL weights
        # (WB_tracking.m:300-315; NB path uses the power weights)
        penv_e = jnp.sqrt(pi_e * pi_e + pq_e * pq_e)
        penv_l = jnp.sqrt(pi_l * pi_l + pq_l * pq_l)
        d_err = (env_e - env_l) / (env_e + env_l + eps)
        p_err = (penv_e - penv_l) / (penv_e + penv_l + eps)
        code_err = (p.dll_scale * (p.dll_data_weight * d_err
                                   + p.dll_pilot_weight * p_err)
                    ).astype(jnp.float64)
    else:
        code_err = ((env_e - env_l)
                    / (env_e + env_l + eps)).astype(jnp.float64)
    code_nco = (st.code_nco
                + (p.tau2_code / p.tau1_code) * (code_err - st.code_err)
                + code_err * (p.pdi / p.tau1_code))
    code_freq = st.code_freq_basis - code_nco

    if p.pilot_period_mod > 1:
        pilot_period = jnp.mod(st.pilot_period + 1, p.pilot_period_mod)
    else:
        pilot_period = st.pilot_period

    new_state = ChannelState(
        carr_freq=carr_freq, carr_freq_basis=st.carr_freq_basis,
        code_freq=code_freq, code_freq_basis=st.code_freq_basis,
        rem_code_phase=rem_code,
        rem_carr_phase=rem_carr,
        carr_nco=carr_nco, carr_err=carr_err,
        code_nco=code_nco, code_err=code_err,
        d_carr=d_carr, d2_carr=d2_carr,
        abs_sample=st.abs_sample + blksize.astype(jnp.int64),
        pilot_period=pilot_period, active=valid)
    # freeze state on inactive/out-of-data channels (keep active=valid)
    new_state = jax.tree.map(lambda n, o: jnp.where(valid, n, o),
                             new_state._replace(active=st.active),
                             st)._replace(active=valid)

    vf = valid.astype(jnp.float32)
    # outputs packed into 3 dtype-homogeneous vectors (one scan
    # dynamic-update-slice each instead of 18 — the per-step DUS ops were
    # ~1/4 of tracking wall time); track_superblock unpacks after the scan
    out_f32 = jnp.stack([
        i_e, q_e, i_p, q_p, i_l, q_l, pi_p, pq_p,
        code_err.astype(jnp.float32), code_nco.astype(jnp.float32),
        carr_err.astype(jnp.float32), carr_nco.astype(jnp.float32)]) * vf
    out_f64 = jnp.stack([st.carr_freq, st.code_freq,
                         st.rem_code_phase, st.rem_carr_phase])
    out_i64 = jnp.stack([st.abs_sample,
                         jnp.where(valid, blksize, 0).astype(jnp.int64)])
    return new_state, (out_f32, out_f64, out_i64)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _correlate_bank_kernel(sig_i, sig_q, n_samples: int, sb_start,
                           code_tables, pilot_tables, tab_len: int,
                           ptab_len: int, st: ChannelState,
                           p: TrackParams):
    """Correlator sums of one epoch for the whole bank through the fused
    GPU kernel (ops/correlator.py).  XLA does only the f64 per-channel
    scalars; every per-sample operation runs in the kernel.  Window
    offsets are clamped exactly as the XLA epoch's dynamic_slice clamps
    them, so both paths read the same windows.  State leaves are [C].
    Returns (blksize, code_phase_step, inc, sums [C, 12])."""
    from ..ops.correlator import correlate_bank

    k = p.k_spacing
    code_phase_step, blksize = _block_size(st, p)
    start, alpha, pstart, palpha = _replica_windows(st, p)
    wlen = p.blk + 2 * k + 1
    start = jnp.clip(start, 0, tab_len - wlen)
    pstart = jnp.clip(pstart, 0, ptab_len - wlen)
    # i64 offsets: the flat time-parallel bank spans the whole record
    # with sb_start=0
    off = jnp.clip(st.abs_sample - sb_start, 0, n_samples - p.blk)

    inc = _TWO_PI * st.carr_freq / p.fs            # f64 rad/sample
    n_pilot = (2 if p.has_pilot2 else 1) if p.has_pilot else 0
    out = correlate_bank(
        sig_i, sig_q, code_tables, pilot_tables, off, start, pstart,
        alpha, palpha, blksize, st.rem_carr_phase / _TWO_PI,
        st.carr_freq / p.fs, blk=p.blk, k=k, n_pilot=n_pilot,
        interp_taps=p.interp_taps, interpret=p.pallas_interpret)
    if p.has_pilot:
        psums = _combine_pilot(out[:, 6:12],
                               out[:, 12:18] if p.has_pilot2 else None, p)
    else:
        psums = jnp.zeros_like(out)
    return blksize, code_phase_step, inc, jnp.concatenate(
        [out[:, :6], psums], axis=1)


def _bank_correlator(samples_iq, sb_start, code_tables, pilot_tables,
                     params: TrackParams):
    """Stage one superblock for the bank's correlator path and return
    ``corr(state) -> (blksize, code_phase_step, inc, sums [C, 12])``.

    The fused kernel (params.use_pallas, fast replica path) takes the
    record as separate I and Q planes, zero-padded so that every tile it
    reads stays inside the arrays; the XLA epoch vmaps over channels."""
    if not (params.use_pallas and params.fast_code):
        vm = jax.vmap(_correlate_one_channel,
                      in_axes=(None, None, 0, 0, 0, None))
        return lambda st: vm(samples_iq, sb_start, code_tables,
                             pilot_tables, st, params)

    from ..ops.correlator import geometry
    if samples_iq.dtype == jnp.int16:
        sig_i, sig_q = samples_iq[0::2], samples_iq[1::2]
    else:
        if samples_iq.dtype == jnp.uint16:
            v16 = samples_iq
        else:
            # int8 interleaved: I is the low byte of each int16 pair
            # (little-endian); int8 truncation keeps exactly that byte
            v16 = jax.lax.bitcast_convert_type(
                samples_iq.reshape(-1, 2), jnp.int16)
        sig_i = v16.astype(jnp.int8)
        sig_q = (v16 >> 8).astype(jnp.int8)
    n_samples = sig_i.shape[0]
    tab_len, ptab_len = code_tables.shape[-1], pilot_tables.shape[-1]
    pad = geometry(params.blk, code_tables.shape[0])[2]

    def zpad(x):
        return jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])

    sig_i, sig_q = zpad(sig_i), zpad(sig_q)
    code_tables, pilot_tables = zpad(code_tables), zpad(pilot_tables)

    def corr(st):
        return _correlate_bank_kernel(
            sig_i, sig_q, n_samples, sb_start, code_tables, pilot_tables,
            tab_len, ptab_len, st, params)
    return corr


@functools.partial(jax.jit, static_argnames=("params",))
def epoch_correlators(samples_iq, sb_start, code_tables, pilot_tables,
                      state: ChannelState, params: TrackParams):
    """Correlator sums [C, 12] (iE qE iP qP iL qL piE pqE piP pqP piL
    pqL) of the bank's next epoch, on the path ``params`` selects — what
    the parity checks compare with tracking/reference.py."""
    corr = _bank_correlator(samples_iq, sb_start, code_tables,
                            pilot_tables, params)
    return corr(state)[3]


@functools.partial(jax.jit, static_argnames=("params", "n_epochs"))
def track_superblock(samples_iq, sb_start, code_tables, pilot_tables,
                     state: ChannelState, params: TrackParams,
                     n_epochs: int, end_sample=None):
    """Track all channels through ``n_epochs`` code periods.

    samples_iq: superblock on device — [S] uint16 PACKED with int8 I in
    the low byte / int8 Q in the high byte (the free host-side
    ``np.int8_array.view(np.uint16)``; preferred), [2S] int8 interleaved
    I/Q, or [2S] int16 interleaved 16-bit samples (cfg.data_type ==
    "int16")
    sb_start:   absolute sample index of samples_iq[0]
    code_tables/pilot_tables: [C, E] int8 element tables
    end_sample: absolute end of the record (channels whose next window
    crosses it freeze, tracking.m:241-245) — scalar or per-channel [C]
    (the sharded time-block path tracks blocks with different buffer
    ends in one flat bank); default = end of superblock
    Returns (new_state, TrackOutputs with [n_epochs, C] leaves).
    """
    step = _prepare_bank(samples_iq, sb_start, code_tables, pilot_tables,
                         state, params, end_sample)
    new_state, packed = jax.lax.scan(
        lambda st, _: step(st), state, None, length=n_epochs)
    return _finish_bank(new_state, packed)


def _prepare_bank(samples_iq, sb_start, code_tables, pilot_tables,
                  state: ChannelState, params: TrackParams,
                  end_sample=None):
    """Stage one channel bank for epoch stepping and return
    ``step(state) -> (state, packed_outputs)``, which advances the bank
    one epoch — the composable unit the concurrent multi-signal driver
    (tracking/multi.py) schedules several of inside one program."""
    n_ch = state.carr_freq.shape[0]
    n_total = (samples_iq.shape[0] if samples_iq.dtype == jnp.uint16
               else samples_iq.shape[0] // 2)
    if end_sample is None:
        end_sample = sb_start + n_total
    end_sample = jnp.broadcast_to(
        jnp.asarray(end_sample, jnp.int64), (n_ch,))
    corr = _bank_correlator(samples_iq, sb_start, code_tables,
                            pilot_tables, params)

    def step(st):
        blksize, code_phase_step, inc, sums = corr(st)
        return _close_epoch(st, params, blksize, code_phase_step, inc,
                            end_sample, *(sums[:, j] for j in range(12)))

    return step


def _finish_bank(new_state, packed):
    """Unpack the scan's dtype-homogeneous output stacks into
    TrackOutputs."""
    o32, o64, oi = packed
    # o32: [E, 12, C]; o64: [E, 4, C]; oi: [E, 2, C]
    outs = TrackOutputs(
        i_e=o32[:, 0], q_e=o32[:, 1], i_p=o32[:, 2], q_p=o32[:, 3],
        i_l=o32[:, 4], q_l=o32[:, 5],
        pilot_ip=o32[:, 6], pilot_qp=o32[:, 7],
        dll_discr=o32[:, 8], dll_filt=o32[:, 9],
        pll_discr=o32[:, 10], pll_filt=o32[:, 11],
        carr_freq=o64[:, 0], code_freq=o64[:, 1],
        rem_code_phase=o64[:, 2], rem_carr_phase=o64[:, 3],
        abs_sample=oi[:, 0], blksize=oi[:, 1])
    return new_state, outs


# --------------------------------------------------------------------------
# Host orchestration
# --------------------------------------------------------------------------

class TrackResults:
    """Per-channel tracking results (numpy), mirroring trackResults.

    ``active_until[c]`` is the first epoch at which channel c stopped
    producing valid correlations (out of data / lock lost / dropped) —
    n_epochs when the channel ran to the end.  ``status[c]`` mirrors
    showChannelStatus.m: 'T' tracking, '-' dropped.
    """

    def __init__(self, prns, outputs: dict, cfg):
        self.prns = prns
        for k, v in outputs.items():
            setattr(self, k, v)
        n_epochs = self.i_p.shape[1]
        alive = np.asarray(self.blksize) > 0     # [C, E]
        self.active_until = np.where(
            alive.any(axis=1),
            n_epochs - np.argmax(alive[:, ::-1], axis=1),
            0).astype(np.int64)
        self.status = ['T' if a == n_epochs else '-'
                       for a in self.active_until]
        self.cno = {}
        vsm = cfg.cno.vsm_interval_ms
        for c in range(len(prns)):
            vals = []
            for s in range(0, n_epochs - vsm + 1, vsm):
                vals.append(cno_vsm(self.i_p[c, s:s + vsm],
                                    self.q_p[c, s:s + vsm],
                                    cfg.cno.acc_time_s))
            self.cno[c] = np.asarray(vals)


def build_replica_tables(cfg, sig: SignalDef, params: TrackParams,
                         channels: Sequence, dopplers) -> tuple:
    """Pre-sampled E/P/L source replicas for the fast tracking path.

    Returns (code_tables, pilot_tables) float32 [C, blk + 2*up_margin]
    where index m holds the code at chip phase (m - up_margin)*step_c,
    step_c the channel's Doppler-aided code step."""
    m0 = params.up_margin
    length = params.blk + 2 * m0
    c = len(channels)
    ctabs = np.empty((c, length), np.int8)
    # long pilot (L2C CL): the table spans the full pilot period so the
    # per-epoch slice can advance one code period per epoch
    mod = max(params.pilot_period_mod, 1)
    spc_max = int(np.ceil(cfg.sampling_freq * sig.code_length_chips
                          / sig.chip_rate_hz)) + 2
    plength = length + (mod - 1) * spc_max if mod > 1 else length
    if params.has_pilot2:
        # dual pilot bank (B1C WB QMBOC): bank 0 = BOC(1,1) pilot,
        # bank 1 = BOC(6,1), sampled on the same sample grid
        ptabs = np.zeros((c, 2, plength), np.int8)
    else:
        ptabs = np.zeros((c, plength), np.int8)
    for k, ch in enumerate(channels):
        code_freq = sig.chip_rate_hz * (
            1.0 + dopplers[k] / sig.carrier_freq_hz)
        phase0 = -m0 * code_freq / cfg.sampling_freq
        elems = sig.data_code(0 if sig.fdma else int(ch[0]))
        ctabs[k] = sample_code_any(elems, sig.code_length_chips,
                                   code_freq, cfg.sampling_freq, length,
                                   phase0)
        if params.has_pilot2:
            for b, pfn in enumerate((sig.pilot_code, sig.pilot_code_wb)):
                ptabs[k, b] = sample_code_any(
                    pfn(int(ch[0])), sig.code_length_chips, code_freq,
                    cfg.sampling_freq, plength, phase0)
        elif params.has_pilot:
            pel = sig.pilot_code(int(ch[0]))
            ptabs[k] = sample_code_any(pel, sig.code_length_chips * mod,
                                       code_freq, cfg.sampling_freq,
                                       plength, phase0)
    return ctabs, ptabs


def build_element_tables(cfg, sig: SignalDef, params: TrackParams,
                         channels: Sequence) -> tuple:
    """Chip-grid element tables for the slow gather path.

    Dual-bank WB pilots are concatenated along the element axis
    (bank 2 indexed at offset code_len*pilot_epc,
    _correlate_one_channel)."""
    fdma = sig.fdma
    ctabs = np.stack([sig.data_code(0 if fdma else int(ch[0]))
                      for ch in channels])
    if not params.has_pilot:
        return ctabs, np.zeros_like(ctabs)
    if params.has_pilot2:
        ptabs = np.stack([np.concatenate([sig.pilot_code(int(ch[0])),
                                          sig.pilot_code_wb(int(ch[0]))])
                          for ch in channels])
    else:
        ptabs = np.stack([sig.pilot_code(int(ch[0])) for ch in channels])
    return ctabs, ptabs


def sample_code_any(elements, code_len_chips, code_freq, fs, n, phase0):
    """Nearest-element sampling with the element grid derived from the
    array length (handles BOC(6,1) etc.).  int8: codes are exactly ±1
    (0 in TMRZ slots), and int8 tables quarter the per-epoch HBM read
    traffic of the replica windows."""
    epc = len(elements) // code_len_chips
    idx = np.floor((phase0 + np.arange(n) * (code_freq / fs))
                   * epc).astype(np.int64) % len(elements)
    return elements[idx].astype(np.int8)


def make_track_params(cfg, sig: SignalDef) -> TrackParams:
    from .loop_filters import calc_loop_coef_carr3, calc_loop_coef_exact
    coef = calc_loop_coef_exact if cfg.loop_design == "exact" \
        else lambda bw, z, k, _t: calc_loop_coef(bw, z, k)
    t1c, t2c = coef(cfg.dll_noise_bandwidth,
                    cfg.dll_damping_ratio, 1.0, cfg.int_time)
    t1p, t2p = coef(cfg.pll_noise_bandwidth,
                    cfg.pll_damping_ratio, 0.25, cfg.int_time)
    pf1, pf2, pf3 = calc_loop_coef_carr3(cfg.pll_noise_bandwidth,
                                         cfg.int_time)
    spc = cfg.samples_per_code
    # data/pilot combining weights: squared acquisition amplitude weights
    # (B1C 11/40 + 29/40, NB_tracking.m:330-349; others 50/50)
    if len(sig.acq_weights) >= 2:
        w = np.asarray(sig.acq_weights[:2], np.float64) ** 2
        wd, wp = (w / w.sum()).tolist()
    else:
        wd = wp = 0.5
    dll_wd, dll_wp = wd, wp
    pilot_epc = 0
    dll_scale = 1.0
    has_pilot2 = False
    pilot2_epc = 0
    pilot_w1, pilot_w2 = 1.0, 0.0
    wb_rot = None
    if cfg.pilot_trk_flag == 2 and sig.pilot_code_wb is not None:
        # WB QMBOC mode (WB_tracking.m): DUAL pilot bank — BOC(1,1) and
        # BOC(6,1) tracked simultaneously and combined into the composite
        # -sqrt(4/33)·p61 - j·sqrt(29/33)·p11 (WB_tracking.m:364-369);
        # PLL 1/4+3/4, DLL factor/(1-factor) with (1-spacing) scaling
        from .qmboc import calc_weighing_factor
        factor = calc_weighing_factor(sig.chip_rate_hz, cfg.front_end_bw)
        wd, wp = 0.25, 0.75
        dll_wd, dll_wp = factor, 1.0 - factor
        dll_scale = 1.0 - cfg.dll_correlator_spacing
        has_pilot2 = True
        pilot2_epc = sig.pilot_wb_elements_per_chip
        pilot_w1, pilot_w2 = np.sqrt(29.0 / 33.0), np.sqrt(4.0 / 33.0)
        # rotations put both banks' sums on +I: the +Q BOC(1,1) pilot
        # turns by -j (rot 3), the -I BOC(6,1) by -1 (rot 2)
        wb_rot = 3
    # fast sliced-replica path needs >= 1 sample of correlator spacing
    k_nominal = cfg.dll_correlator_spacing * cfg.sampling_freq \
        / sig.chip_rate_hz
    fast = k_nominal >= 0.5
    if not fast:
        import warnings
        warnings.warn(
            f"{sig.name}: correlator spacing {cfg.dll_correlator_spacing} "
            f"chips is under half a sample at fs={cfg.sampling_freq:.3e}; "
            "falling back to the slow per-epoch gather path",
            stacklevel=2)
    # the fused correlator kernel on GPU backends, the XLA epoch
    # elsewhere; asking for the kernel off the GPU is an error
    use_pallas = cfg.use_pallas
    if use_pallas is None:
        use_pallas = jax.devices()[0].platform == "gpu"
    elif use_pallas:
        from ..ops.correlator import require_gpu
        require_gpu()
    has_pilot = cfg.pilot_trk_flag > 0 and sig.pilot_code is not None
    return TrackParams(
        fast_code=fast, k_spacing=max(int(round(k_nominal)), 1),
        use_pallas=bool(use_pallas and fast),
        pilot_rot=(wb_rot if wb_rot is not None
                   else (0 if sig.pilot_in_phase else 1)),
        has_pilot2=has_pilot2, pilot2_rot=(4 - sig.pilot_wb_rot) % 4,
        pilot2_epc=pilot2_epc, pilot_w1=float(pilot_w1),
        pilot_w2=float(pilot_w2),
        pilot_period_mod=(sig.pilot_phase_hypotheses
                          if has_pilot and sig.pilot_phase_hypotheses > 1
                          else 0),
        fs=cfg.sampling_freq, code_len=sig.code_length_chips,
        elements_per_chip=sig.elements_per_chip,
        code_freq_basis=sig.chip_rate_hz,
        blk=spc + cfg.track_block_pad,
        spacing=cfg.dll_correlator_spacing,
        tau1_code=t1c, tau2_code=t2c, tau1_carr=t1p, tau2_carr=t2p,
        pdi=cfg.int_time,
        interp_taps=cfg.interp_taps,
        has_pilot=has_pilot,
        data_weight=wd, pilot_weight=wp,
        dll_data_weight=dll_wd, dll_pilot_weight=dll_wp,
        pilot_epc=pilot_epc, dll_scale=dll_scale,
        pll_order=cfg.pll_order, pf1=pf1, pf2=pf2, pf3=pf3)


def track(cfg, sig: SignalDef, samples_iq: np.ndarray,
          channels: Sequence, n_epochs: Optional[int] = None,
          superblock_epochs: Optional[int] = None) -> TrackResults:
    """Host driver: stage superblocks, run the jitted engine, collect
    results.

    samples_iq: int8 interleaved I/Q for the whole record
    channels: [(prn, acquired_carr_freq, code_phase_samples)]
    """
    params = make_track_params(cfg, sig)
    spc = cfg.samples_per_code
    samples_iq = np.ascontiguousarray(np.asarray(samples_iq))
    if samples_iq.dtype == np.int8:
        # packed uint16: free host-side deinterleave (track_superblock)
        samples_i16, _eps = samples_iq.view(np.uint16), 1
    else:
        samples_i16, _eps = samples_iq, 2      # interleaved int16
    total_samples = len(samples_iq) // 2
    max_phase = max(ch[2] for ch in channels)
    if n_epochs is None:
        n_epochs = int((total_samples - max_phase - 2 * spc) // spc)
    sb_epochs = superblock_epochs or min(
        n_epochs, max(int(cfg.superblock_ms / sig.code_period_ms), 1))

    # Doppler-aided code rates (tables + state init, preRun.m:71-73)
    fdma = sig.fdma
    if_offsets0 = np.zeros(len(channels))
    if fdma:
        if_offsets0 = np.asarray([sig.fdma_spacing_hz * ch[0]
                                  for ch in channels])
    dopplers0 = (np.asarray([ch[1] for ch in channels], np.float64)
                 - cfg.if_freq - if_offsets0)
    if params.fast_code:
        # fast path: pre-sampled replicas sliced per epoch
        ctabs, ptabs = build_replica_tables(cfg, sig, params, channels,
                                            dopplers0)
    else:
        ctabs, ptabs = build_element_tables(cfg, sig, params, channels)
    ctabs_d = jnp.asarray(ctabs)
    ptabs_d = jnp.asarray(ptabs)

    state = init_channel_state(channels, sig.chip_rate_hz,
                               dopplers=dopplers0,
                               carrier_freq_hz=sig.carrier_freq_hz)
    end_sample = jnp.int64(total_samples)
    vsm = cfg.cno.vsm_interval_ms
    low_lock = np.zeros(len(channels), np.int32)
    base_pwr = [None]
    chunks = []
    drop_ratio = 10.0 ** (-cfg.lock_power_drop_db / 10.0)

    def drain(outs, cur):
        """Fetch a dispatched superblock's outputs (host blocks only on
        THAT program; later dispatches keep the device busy) and run the
        lock gate on it.  Returns a drop mask to apply to the carry
        state before the next dispatch.

        Lock gate: PLL NBD/NBP detector (Calc_CNo_PLD.m) plus a
        RELATIVE prompt-power gate against the channel's running-max
        power baseline (the rectified-I detector saturates near 1 on
        pure noise, so a blackout only shows in power).  A channel
        failing either gate for 2 consecutive superblocks is dropped —
        the reference's channel lifecycle ('T' -> '-',
        showChannelStatus.m) made per-channel.  Because the fetch is
        pipelined one superblock behind the dispatch, a drop takes
        effect one superblock later than in a fully synchronous loop.
        """
        out_np = jax.tree.map(np.asarray, outs)
        chunks.append(out_np)
        if not (cfg.lock_detect and cur >= vsm):
            return None
        from .cno import pll_lock_detector
        alive = out_np.blksize[-1] > 0
        pwr = (out_np.i_p.astype(np.float64) ** 2
               + out_np.q_p.astype(np.float64) ** 2).mean(axis=0)
        # baseline = running max of per-superblock prompt power, so a
        # slow pull-in (first superblock still converging) cannot
        # understate it; a blackout then always shows as a drop
        if base_pwr[0] is None:
            base_pwr[0] = pwr.copy()
        else:
            base_pwr[0] = np.maximum(base_pwr[0], pwr)
        for c in range(len(channels)):
            if not alive[c]:
                continue
            pld = pll_lock_detector(out_np.i_p[-vsm:, c],
                                    out_np.q_p[-vsm:, c])
            bad = (pld < cfg.lock_threshold
                   or pwr[c] < drop_ratio * base_pwr[0][c])
            low_lock[c] = low_lock[c] + 1 if bad else 0
        drop = low_lock >= 2
        return drop if drop.any() else None

    # ---- pipelined superblock loop (the PP-analog of the build) -----------
    # The reference serializes read -> track -> decode (postProcessing.m:
    # 100-134).  Here superblock k+1's host work — window staging, H2D
    # transfer, dispatch — and the lock gate on superblock k-1 overlap
    # the device's compute of superblock k: window bounds are ANALYTIC
    # (per-epoch block size stays within spc±2 samples of nominal), so
    # the host never synchronizes on device state inside the loop, and
    # output fetches lag dispatch by one superblock.  Buffers are padded
    # to a shared size so the engine compiles ONCE for the whole record.
    min_phase0 = min(ch[2] for ch in channels)
    done = 0
    pending = None
    drop_mask = None
    buf_len = None
    while done < n_epochs:
        cur = min(sb_epochs, n_epochs - done)
        drift = 2 * (done + cur + 3)
        sb_start = max(min_phase0 + done * spc - drift - spc, 0)
        need = (max_phase + (done + cur + 3) * spc + drift
                + params.blk + 256 - sb_start)
        if buf_len is None:
            # shared buffer size: the last (largest-drift) window of the
            # run, rounded up — every superblock reuses one program
            drift_end = 2 * (n_epochs + 3)
            buf_len = _round_up(
                max_phase - min_phase0 + (sb_epochs + 4) * spc
                + 2 * drift_end + params.blk + 256, 4 * spc)
        buf_len = max(buf_len, _round_up(need, 4 * spc))
        buf = np.zeros(_eps * buf_len, samples_i16.dtype)
        lo, hi = sb_start, min(sb_start + buf_len, total_samples)
        buf[:_eps * (hi - lo)] = samples_i16[_eps * lo:_eps * hi]
        if drop_mask is not None:
            state = state._replace(active=jnp.logical_and(
                state.active, jnp.asarray(~drop_mask)))
        state, outs = track_superblock(
            jnp.asarray(buf), jnp.int64(sb_start), ctabs_d, ptabs_d,
            state, params, cur, end_sample)
        done += cur
        if pending is not None:
            drop_mask = drain(*pending)     # lags one superblock
        pending = (outs, cur)
    if pending is not None:
        drain(*pending)

    merged = {}
    for fieldname in TrackOutputs._fields:
        merged[fieldname] = np.concatenate(
            [getattr(c, fieldname) for c in chunks], axis=0).T  # [C, E]
    return TrackResults([ch[0] for ch in channels], merged, cfg)
