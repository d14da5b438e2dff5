#!/usr/bin/env python
"""Headline benchmark: GPS L1 C/A acquisition + 12-channel tracking
throughput on one NVIDIA GPU (it refuses to run on any other platform).

Workload mirrors the reference default (GPS/GPS_L1CA/initSettings.m:44-105):
18 Msps complex IF, 32-PRN x 29-Doppler-bin x 20 ms non-coherent PCPS
acquisition, then 12-channel DLL/PLL tracking.  Metric is IF
samples/sec/chip for the combined pipeline (BASELINE.json), with
vs_baseline = ratio to real-time (18 Msps: a receiver below 1.0 cannot keep
up with its own antenna).

Every stage is individually guarded and a full cumulative JSON line is
printed (and flushed) after EACH stage, so a later-stage crash can never
zero the numbers of stages that already ran: the LAST stdout line is
always a valid result for whatever completed (rounds 2-4 each lost a
working measurement to a single failing stage).
"""

import json
import os
import sys
import time
import traceback

import numpy as np


def _dbg(msg, _t0=[None]):
    if _t0[0] is None:
        _t0[0] = time.perf_counter()
    print(f"[bench +{time.perf_counter()-_t0[0]:7.1f}s] {msg}",
          file=sys.stderr, flush=True)


STAGES = {}
ERRORS = {}
CARD = ""           # nvidia-smi name and power limit


def _emit(cfg_fs):
    """Print the cumulative result line from whatever stages completed."""
    import jax
    d = dict(STAGES)
    track_rates = [d.get("track_samples_per_s_sequential", 0.0),
                   d.get("track_samples_per_s_timeparallel", 0.0),
                   d.get("track_samples_per_s_timeparallel_nearest",
                         0.0)]
    track_rate = max(track_rates)
    total_samples = 60.0 * cfg_fs                 # reference 60 s record
    t_acq = d.get("acq_time_s")
    if track_rate > 0:
        t_total = (t_acq or 0.0) + total_samples / track_rate
        samples_per_sec = total_samples / t_total
    elif t_acq:
        samples_per_sec = 0.0
    else:
        samples_per_sec = 0.0
    rt = samples_per_sec / cfg_fs
    detail = dict(d)
    detail["realtime_factor"] = round(rt, 3)
    d0 = jax.devices()[0]
    detail["device"] = {"platform": d0.platform, "kind": d0.device_kind,
                        "count": len(jax.devices()), "card": CARD}
    if ERRORS:
        detail["stage_errors"] = {k: v[-400:] for k, v in ERRORS.items()}
    print(json.dumps({
        "metric": "IF samples/sec/chip (acq + 12-ch tracking)",
        "value": round(samples_per_sec, 1),
        "unit": "samples/s",
        "vs_baseline": round(rt, 3),
        "detail": detail,
    }), flush=True)


def _stage(name, fn, cfg_fs):
    _dbg(f"stage {name}...")
    try:
        fn()
        _dbg(f"stage {name} done")
    except Exception:
        ERRORS[name] = traceback.format_exc()
        _dbg(f"stage {name} FAILED:\n{ERRORS[name]}")
    _emit(cfg_fs)


def main():
    from cusdr_tpu.runtime.cache import enable_persistent_cache
    cache = enable_persistent_cache()
    _dbg(f"compile cache: {cache}")

    import subprocess

    import jax
    import jax.numpy as jnp

    if jax.devices()[0].platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX runs on "
                 f"{jax.devices()[0].platform!r}")
    global CARD
    CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    _dbg(f"card: {CARD}")

    from cusdr_tpu import get_config
    from cusdr_tpu.signals.defs import get_signal, sample_code
    from cusdr_tpu.acquisition.pcps import _pcps_cdma_kernel
    from cusdr_tpu.tracking.engine import (build_replica_tables,
                                           init_channel_state,
                                           make_track_params,
                                           track_superblock)

    cfg = get_config("gps_l1ca")      # 18 Msps, 12 channels, 20 ms noncoh
    sig = get_signal("gps_l1ca")
    spc = cfg.samples_per_code        # 18000
    rng = np.random.default_rng(0)

    # ---------------- acquisition workload --------------------------------
    def stage_acq():
        search_len = 2 * spc
        nfft = 1 << (search_len - 1).bit_length()   # pow2 FFT (65536)
        noncoh = cfg.acq_non_coh_time
        slabs_r = np.zeros((noncoh, nfft), np.float32)
        slabs_i = np.zeros((noncoh, nfft), np.float32)
        slabs_r[:, :search_len] = rng.standard_normal(
            (noncoh, search_len)).astype(np.float32)
        slabs_i[:, :search_len] = rng.standard_normal(
            (noncoh, search_len)).astype(np.float32)
        prns = list(cfg.acq_satellite_list)
        cf_r = np.zeros((len(prns), 1, nfft), np.float32)
        cf_i = np.zeros((len(prns), 1, nfft), np.float32)
        for i, p in enumerate(prns):
            padded = np.zeros(nfft, np.float32)
            padded[:spc] = sample_code(sig.data_code(p), 1,
                                       sig.chip_rate_hz,
                                       cfg.sampling_freq, spc)
            cfc = np.conj(np.fft.fft(padded))
            cf_r[i, 0] = cfc.real
            cf_i[i, 0] = cfc.imag
        f_grid = (cfg.if_freq + cfg.acq_search_band
                  - cfg.acq_search_step
                  * np.arange(cfg.num_freq_bins)).astype(np.float32)
        ts = np.float32(1.0 / cfg.sampling_freq)
        args = ((jnp.asarray(slabs_r), jnp.asarray(slabs_i)),
                (jnp.asarray(cf_r), jnp.asarray(cf_i)),
                jnp.ones(1, jnp.float32), jnp.asarray(f_grid), ts)

        # synchronize by fetching the small outputs to the host
        def run_acq():
            peak, b, ph, second, floor = _pcps_cdma_kernel(
                *args, n_noncoh=noncoh, n_comp=1, search_len=search_len)
            return np.asarray(peak)

        run_acq()                          # compile
        t0 = time.perf_counter()
        run_acq()
        t_acq = time.perf_counter() - t0
        grid_points = len(prns) * cfg.num_freq_bins * nfft * noncoh
        STAGES["acq_time_s"] = round(t_acq, 4)
        STAGES["acq_grid_points_per_s"] = round(grid_points / t_acq, 1)

    # ---------------- shared tracking setup --------------------------------
    n_channels = cfg.num_channels
    params = make_track_params(cfg, sig)
    channels = [(1 + k, cfg.if_freq + 500.0 * (k - 6), k * 1499)
                for k in range(n_channels)]
    dops = [c[1] - cfg.if_freq for c in channels]
    ctabs_np, ptabs_np = build_replica_tables(cfg, sig, params, channels,
                                              dops)
    ctabs = jnp.asarray(ctabs_np)
    ptabs = jnp.asarray(ptabs_np)
    state = init_channel_state(channels, sig.chip_rate_hz,
                               dopplers=dops,
                               carrier_freq_hz=sig.carrier_freq_hz)

    # ---------------- sequential tracking ----------------------------------
    n_epochs = 2000                    # 2 s of signal per timed run

    def stage_seq():
        n_samples = (n_epochs + 4) * spc
        samples = rng.integers(-16, 16, 2 * n_samples).astype(np.int8)
        samples_d = jnp.asarray(samples.view(np.uint16))

        def run_track():
            st, outs = track_superblock(samples_d, jnp.int64(0), ctabs,
                                        ptabs, state, params, n_epochs)
            return np.asarray(st.carr_freq)   # small fetch = real sync

        run_track()                        # compile
        t0 = time.perf_counter()
        run_track()
        t_track = time.perf_counter() - t0
        STAGES["track_samples_per_s_sequential"] = round(
            n_epochs * spc / t_track, 1)

    # ---------------- time-parallel tracking --------------------------------
    # The sequence-parallel axis (parallel/timeblocks.py) also pays off
    # on one device: B concurrent blocks give the card far more parallel
    # work than one serial scan.  Flat formulation: one B*C-row channel
    # bank over the full record, read by the correlator kernel.  The
    # record rides to the device as packed uint16 (host .view).
    def stage_tp():
        use_flat = params.use_pallas
        n_epochs_tp = 10_000 if use_flat else n_epochs
        n_blocks = 100 if use_flat else 10
        epb = n_epochs_tp // n_blocks
        starts_np = np.arange(n_blocks, dtype=np.int64) * (epb * spc)
        starts = jnp.asarray(starts_np)
        st_b = jax.tree.map(lambda x: jnp.stack([x] * n_blocks), state)
        st_b = st_b._replace(abs_sample=st_b.abs_sample + starts[:, None])
        samples_tp = rng.integers(
            -16, 16, 2 * (n_epochs_tp + 4) * spc).astype(np.int8)

        if use_flat:
            from cusdr_tpu.parallel.timeblocks import _track_blocks_flat
            samples_tp_d = jnp.asarray(samples_tp.view(np.uint16))
            jax.block_until_ready(samples_tp_d)

            def run_track_tp():
                st, outs = _track_blocks_flat(samples_tp_d, ctabs, ptabs,
                                              st_b, params, epb, n_blocks)
                return np.asarray(st.carr_freq)
        else:
            from cusdr_tpu.parallel.timeblocks import _track_blocks
            blk_len = (epb + 4) * spc
            s16 = samples_tp.view(np.uint16)
            sbs = np.stack([s16[s:s + blk_len] for s in starts_np])
            ends = jnp.asarray(starts_np + blk_len)
            sbs_d = jnp.asarray(sbs)

            def run_track_tp():
                st, outs = _track_blocks(sbs_d, starts, ends, ctabs,
                                         ptabs, st_b, params, epb)
                return np.asarray(st.carr_freq)

        run_track_tp()                     # compile
        t0 = time.perf_counter()
        run_track_tp()
        t_track_tp = time.perf_counter() - t0
        STAGES["track_samples_per_s_timeparallel"] = round(
            n_epochs_tp * spc / t_track_tp, 1)
        STAGES["timeparallel_blocks"] = n_blocks
        STAGES["timeparallel_record_s"] = round(n_epochs_tp
                                                * sig.code_period_ms
                                                / 1000.0, 1)

        if use_flat:
            # reference-parity fidelity: nearest-sample taps — the
            # reference's own ceil-index replica lookup
            # (tracking.m:252-270; it never interpolates sub-sample).
            # The default keeps interp ON (a fidelity upgrade); this is
            # the apples-to-apples number against the reference.
            import dataclasses
            p_near = dataclasses.replace(params, interp_taps=False)

            def run_near():
                st, outs = _track_blocks_flat(samples_tp_d, ctabs,
                                              ptabs, st_b, p_near, epb,
                                              n_blocks)
                return np.asarray(st.carr_freq)

            run_near()                     # compile
            t0 = time.perf_counter()
            run_near()
            STAGES["track_samples_per_s_timeparallel_nearest"] = round(
                n_epochs_tp * spc / (time.perf_counter() - t0), 1)

    # ---------------- concurrent multi-signal (EP axis) ---------------------
    # Two constellations' channel banks — GPS L1CA and L5C (pilot-aided,
    # 10.23 Mcps) — scheduled in ONE device program on a common 1 ms
    # subepoch (tracking/multi.py).  The reference runs one receiver per
    # signal (SURVEY.md §2.3); the metric is aggregate IF samples/s
    # across both bands.
    def stage_ep():
        from cusdr_tpu.tracking.multi import (BankInputs,
                                              track_superblock_multi)
        n_ep = 2000
        banks, plist = [], []
        for name in ("gps_l1ca", "gps_l5c"):
            c2 = get_config(name)
            s2 = get_signal(name)
            p2 = make_track_params(c2, s2)
            spc2 = c2.samples_per_code
            ch2 = [(1 + k, c2.if_freq + 500.0 * (k - 6), k * 1499)
                   for k in range(12)]
            d2 = [c[1] - c2.if_freq for c in ch2]
            ct2, pt2 = build_replica_tables(c2, s2, p2, ch2, d2)
            st2 = init_channel_state(ch2, s2.chip_rate_hz, dopplers=d2,
                                     carrier_freq_hz=s2.carrier_freq_hz)
            rec = rng.integers(-16, 16,
                               2 * (n_ep + 4) * spc2).astype(np.int8)
            banks.append(BankInputs(jnp.asarray(rec.view(np.uint16)),
                                    jnp.int64(0), jnp.asarray(ct2),
                                    jnp.asarray(pt2), st2,
                                    jnp.int64((n_ep + 4) * spc2)))
            plist.append(p2)

        def run_ep():
            res = track_superblock_multi(tuple(banks), tuple(plist),
                                         (1, 1), n_ep)
            return np.asarray(res[0][0].carr_freq)

        run_ep()                           # compile
        t0 = time.perf_counter()
        run_ep()
        t_ep = time.perf_counter() - t0
        total = 2 * n_ep * spc             # both bands' input samples
        STAGES["multi_signal_samples_per_s"] = round(total / t_ep, 1)
        STAGES["multi_signal_bands"] = "gps_l1ca+gps_l5c"

    fs = cfg.sampling_freq
    _emit(fs)                       # rc-0 line exists from the very start
    _stage("seq_track", stage_seq, fs)
    _stage("tp_track", stage_tp, fs)
    _stage("acq", stage_acq, fs)
    _stage("ep_multi_signal", stage_ep, fs)


if __name__ == "__main__":
    main()
