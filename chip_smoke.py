#!/usr/bin/env python
"""Smoke check of the receiver on NVIDIA GPUs, through the entry points a
user calls.  Run it from the root of a checkout:

    python chip_smoke.py             # one GPU: phases 1-4
    python chip_smoke.py --multi     # four GPUs: the sharded paths only

Phases on one GPU:
  1. device: JAX's platform, device kind and count, and the card's name
     and power limit from nvidia-smi;
  2. kernel parity and timing: the fused correlator kernel and the XLA
     epoch against the float64 reference epoch at the receiver's widths
     (tracking/reference.CARD_CASES), the pinned acquisition products
     against theirs, and a default-precision control of the same
     products; then kernel and XLA epoch times for 12-channel L1CA at
     18 Msps, sequential over 2 s and as the flat 100-block bank over
     10 s;
  3. the reference default end to end: GPS L1CA, 18 Msps complex int8,
     20 kHz IF, 12 channels, a 32-PRN search with 20 ms non-coherent
     acquisition (GPS/GPS_L1CA/initSettings.m:44-70).  A 40 s record of
     6 SVs at 46 dB-Hz, synthesized from --seed, runs through
     `python -m cusdr_tpu run --no-plots --timing` (called in-process),
     once sequential and once with --time-blocks 40.  Each run must
     acquire the truth PRNs and give at least 60 fixes with a mean 3-D
     error under 15 m;
  4. concurrent banks: track_multi on L1CA + L5C at 18 Msps, 12 channels
     each, over 2 s of synthesized IF; the synthesized SVs must lock to
     their truth Doppler.

With --multi, only the sharded paths run: __graft_entry__'s
dryrun_multichip(4), and the phase-3 record through track_time_parallel
on a 2x2 'ch' x 'tb' mesh compared with the single-GPU flat result.

The last line of stdout is one JSON object naming the device.  The
script exits non-zero without it when JAX finds no GPU, outside a
checkout, or when any phase fails.  Everything runs in this one process
(a second JAX process could not claim the card's memory); the record
synthesis uses worker processes that never touch the device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
CACHE = REPO / ".cache"

RECORD_MS = 40_500          # 40 s processed + acquisition/lead margin
TRACK_MS = 40_000
N_SVS, CN0 = 6, 46.0


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_device(n_required: int):
    import jax
    devs = jax.devices()
    d0 = devs[0]
    if d0.platform != "gpu":
        fail(f"JAX finds no GPU (platform {d0.platform!r})")
    check(len(devs) >= n_required,
          f"needs {n_required} GPUs, JAX finds {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    log(f"[1] device platform={d0.platform} kind={d0.device_kind} "
        f"count={len(devs)}")
    for line in smi.stdout.strip().splitlines():
        log(f"[1] nvidia-smi: {line}")
    return {"platform": d0.platform, "kind": d0.device_kind,
            "count": len(devs)}


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def _pcps_at_default(fn, *args):
    """``fn(*args)`` traced afresh with its pinned products at DEFAULT
    precision (the control run of the parity check).  The fresh lambda
    keeps JAX from reusing the pinned trace of ``fn``."""
    import jax
    from cusdr_tpu.acquisition import pcps
    saved = pcps._HIGHEST
    pcps._HIGHEST = jax.lax.Precision.DEFAULT
    try:
        return np.asarray(jax.jit(
            lambda *a: fn.__wrapped__(*a))(*args))
    finally:
        pcps._HIGHEST = saved


def phase_parity():
    import jax
    import jax.numpy as jnp
    from cusdr_tpu.acquisition import pcps
    from cusdr_tpu.acquisition.reference import (fine_inputs,
                                                 fine_powers_f64,
                                                 pilot_inputs,
                                                 pilot_phase_corr_f64)
    from cusdr_tpu.tracking.engine import epoch_correlators
    from cusdr_tpu.tracking.reference import (CARD_CASES, PARITY_TOL,
                                              data_terms_f64,
                                              epoch_correlators_f64,
                                              parity_error, random_bank)

    log(f"[2] parity tolerance {PARITY_TOL:g} of the data operand's L2 "
        f"norm")
    for name, (signal, fs, pilot, interp, sb0) in CARD_CASES.items():
        samples, sb, ct, pt, state, params = random_bank(
            signal, fs, pilot, interp_taps=interp, sb_start=sb0)
        ref, norms = epoch_correlators_f64(samples, sb, ct, pt, state,
                                           params)
        args = (jnp.asarray(samples), jnp.int64(sb), jnp.asarray(ct),
                jnp.asarray(pt), state)
        for path in ("kernel", "xla"):
            p = dataclasses.replace(params, use_pallas=path == "kernel")
            got = epoch_correlators(*args, p)
            err = parity_error(got, ref, norms)
            log(f"[2] parity {name} blk={params.blk} {path}: err={err:.3e}")
            check(err < PARITY_TOL, f"{name} {path} parity {err:.3e}")
        if name in ("l1ca", "b1c_dual_pilot"):
            # control: the data sums as a matrix product, at the default
            # precision and pinned
            bb, taps = data_terms_f64(samples, sb, ct, pt, state, params)
            codes = jnp.asarray(taps, jnp.float32)
            bbm = jnp.asarray(np.stack([bb.real, bb.imag], -1), jnp.float32)
            for prec in ("DEFAULT", "HIGHEST"):
                z = jnp.matmul(codes, bbm,
                               precision=getattr(jax.lax.Precision, prec))
                err = parity_error(np.asarray(z).reshape(len(bb), 6),
                                   ref[:, :6], norms)
                log(f"[2] control {name} correlator as matmul "
                    f"precision={prec}: err={err:.3e} "
                    f"({'fails' if err >= PARITY_TOL else 'passes'})")
                if prec == "HIGHEST":
                    check(err < PARITY_TOL, f"{name} pinned matmul {err}")

    a = fine_inputs(18e6)
    ref, norms = fine_powers_f64(*a)
    dev = tuple(jnp.asarray(x) for x in a[:5]) + (a[5],)
    for label, got in (("pinned", np.asarray(pcps._fine_kernel(*dev))),
                       ("DEFAULT", _pcps_at_default(pcps._fine_kernel,
                                                    *dev))):
        err = parity_error(got[:, None], ref[:, None], norms)
        log(f"[2] parity acquisition fine search 18 Msps {label}: "
            f"err={err:.3e}")
        if label == "pinned":
            check(err < PARITY_TOL, f"fine search parity {err}")
    b = pilot_inputs(8e6)
    ref, norms = pilot_phase_corr_f64(*b)
    dev = tuple(jnp.asarray(x) for x in b[:5]) + (b[5],)
    for label, got in (("pinned", np.asarray(pcps._pilot_phase_corr(*dev))),
                       ("DEFAULT", _pcps_at_default(pcps._pilot_phase_corr,
                                                    *dev))):
        err = parity_error(got, ref, norms)
        log(f"[2] parity acquisition long-pilot search 8 Msps {label}: "
            f"err={err:.3e}")
        if label == "pinned":
            check(err < PARITY_TOL, f"long-pilot search parity {err}")


def _timed(fn):
    fn()                                   # compile + first run
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def phase_timing(seed: int):
    """Kernel and XLA epoch end to end at the bench's shapes; each case
    runs kernel, XLA, kernel, XLA in one process."""
    import jax
    import jax.numpy as jnp
    from cusdr_tpu import get_config
    from cusdr_tpu.parallel.timeblocks import _track_blocks_flat
    from cusdr_tpu.signals.defs import get_signal
    from cusdr_tpu.tracking.engine import (build_replica_tables,
                                           init_channel_state,
                                           make_track_params,
                                           track_superblock)

    cfg = get_config("gps_l1ca")
    sig = get_signal("gps_l1ca")
    params = make_track_params(cfg, sig)
    check(params.use_pallas, "the kernel is not the GPU default")
    spc = cfg.samples_per_code
    rng = np.random.default_rng(seed)
    chans = [(1 + k, cfg.if_freq + 500.0 * (k - 6), k * 1499)
             for k in range(12)]
    dops = [c[1] - cfg.if_freq for c in chans]
    ct, pt = build_replica_tables(cfg, sig, params, chans, dops)
    ct, pt = jnp.asarray(ct), jnp.asarray(pt)
    state = init_channel_state(chans, sig.chip_rate_hz, dopplers=dops,
                               carrier_freq_hz=sig.carrier_freq_hz)
    paths = {"kernel": params,
             "xla": dataclasses.replace(params, use_pallas=False)}

    n_ep = 2000
    rec = jnp.asarray(rng.integers(-16, 16, 2 * (n_ep + 4) * spc).astype(
        np.int8).view(np.uint16))
    for path in ("kernel", "xla", "kernel", "xla"):
        p = paths[path]

        def run():
            st, _ = track_superblock(rec, jnp.int64(0), ct, pt, state, p,
                                     n_ep)
            return np.asarray(st.carr_freq)
        t = _timed(run)
        log(f"[2] timing sequential 12 ch x {n_ep} ms {path}: {t:.4f} s "
            f"= {n_ep * spc / t / 1e6:.1f} Msamp/s")
    del rec

    n_blocks, epb = 100, 100
    rec = jnp.asarray(rng.integers(
        -16, 16, 2 * (n_blocks * epb + 4) * spc).astype(np.int8).view(
            np.uint16))
    starts = jnp.arange(n_blocks, dtype=jnp.int64) * (epb * spc)
    st_b = jax.tree.map(lambda x: jnp.stack([x] * n_blocks), state)
    st_b = st_b._replace(abs_sample=st_b.abs_sample + starts[:, None])
    for path in ("kernel", "xla", "kernel", "xla"):
        p = paths[path]

        def run():
            st, _ = _track_blocks_flat(rec, ct, pt, st_b, p, epb, n_blocks)
            return np.asarray(st.carr_freq)
        t = _timed(run)
        log(f"[2] timing flat {n_blocks} blocks x 12 ch x {epb} ms {path}: "
            f"{t:.4f} s = {n_blocks * epb * spc / t / 1e6:.1f} Msamp/s")


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def l1ca_record(seed: int):
    """The phase-3 record and its scenario, cached under .cache/ by its
    parameters and seed."""
    from cusdr_tpu import get_config
    from cusdr_tpu.io.scenario import make_gps_scenario
    from cusdr_tpu.io.synth import synthesize_iq_int8
    from cusdr_tpu.signals.defs import get_signal

    cfg = get_config("gps_l1ca")
    sig = get_signal("gps_l1ca")
    scn = make_gps_scenario(cfg, sig, n_svs=N_SVS,
                            duration_s=TRACK_MS / 1000.0, cn0_dbhz=CN0)
    key = (f"l1ca_fs{cfg.sampling_freq:.0f}_if{cfg.if_freq:.0f}_"
           f"{RECORD_MS}ms_{N_SVS}sv_{CN0:g}dBHz_seed{seed}")
    path = CACHE / "records" / f"{key}.bin"
    if path.exists():
        log(f"[3] record {path.name} from the cache")
        return path, scn
    path.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    iq = synthesize_iq_int8(cfg, sig, scn.svs, num_ms=RECORD_MS,
                            seed=seed, workers=os.cpu_count() or 1)
    tmp = path.with_suffix(".part")
    iq.tofile(tmp)
    tmp.rename(path)
    log(f"[3] synthesized {path.name} ({iq.nbytes / 1e9:.2f} GB) in "
        f"{time.perf_counter() - t0:.1f} s")
    return path, scn


def phase_e2e(seed: int):
    from cusdr_tpu import checkpoint
    from cusdr_tpu.__main__ import main as cli

    path, scn = l1ca_record(seed)
    truth = {sv.prn for sv in scn.svs}
    for label, extra in (("sequential", []),
                         ("time_blocks_40", ["--time-blocks", "40"])):
        odir = CACHE / "smoke" / label
        argv = ["run", "--signal", "gps_l1ca", "--file", str(path),
                "--ms", str(TRACK_MS), "--out", str(odir), "--no-plots",
                "--timing"] + extra
        log(f"[3] python -m cusdr_tpu {' '.join(argv)}")
        t0 = time.perf_counter()
        rc = cli(argv)
        wall = time.perf_counter() - t0
        check(rc == 0, f"{label}: CLI exit code {rc}")
        acq = checkpoint.load_acquisition(odir / "acqResults.npz")
        got = {int(p) for p, d in zip(acq.prns, acq.detected) if d}
        check(truth <= got, f"{label}: acquired {sorted(got)}, truth "
                            f"{sorted(truth)}")
        nav = np.load(odir / "navResults.npz")
        pos = np.stack([nav["X"], nav["Y"], nav["Z"]], axis=1)
        err = np.linalg.norm(pos - np.asarray(scn.rx_ecef)[None], axis=1)
        log(f"[3] {label}: wall {wall:.1f} s, acquired {sorted(got)}, "
            f"{len(err)} fixes, 3-D error mean {err.mean():.2f} m "
            f"max {err.max():.2f} m")
        check(len(err) >= 60, f"{label}: {len(err)} fixes")
        check(err.mean() < 15.0, f"{label}: mean error {err.mean():.2f} m")


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------

def phase_multi_band(seed: int):
    from cusdr_tpu import get_config
    from cusdr_tpu.io.synth import SynthSV, synthesize_iq_int8
    from cusdr_tpu.signals.defs import get_signal
    from cusdr_tpu.tracking.multi import track_multi

    rng = np.random.default_rng(seed)
    specs, truths = [], []
    for name in ("gps_l1ca", "gps_l5c"):
        cfg = get_config(name, sampling_freq=18e6)
        sig = get_signal(name)
        spc = cfg.samples_per_code
        svs = [SynthSV(prn=3 + 5 * k,
                       code_phase=float(rng.uniform(0, spc)),
                       doppler_hz=float(rng.uniform(-3000, 3000)),
                       cn0_dbhz=48.0,
                       carrier_phase=float(rng.uniform(0, 2 * np.pi)))
               for k in range(4)]
        iq = synthesize_iq_int8(cfg, sig, svs, num_ms=2100, seed=seed,
                                workers=os.cpu_count() or 1)
        # the synthesized SVs start 30 Hz off their truth (an
        # acquisition-grade error); 8 more channels track absent PRNs
        chans = [(sv.prn, cfg.if_freq + sv.doppler_hz + 30.0,
                  int(round(sv.code_phase))) for sv in svs]
        absent = [p for p in range(1, 33) if p not in [s.prn for s in svs]]
        chans += [(prn, cfg.if_freq + 250.0 * k, 997 * k)
                  for k, prn in enumerate(absent[:8])]
        specs.append((cfg, sig, iq, chans))
        truths.append([cfg.if_freq + sv.doppler_hz for sv in svs])
    t0 = time.perf_counter()
    res = track_multi(specs, n_ms=2000)
    wall = time.perf_counter() - t0
    for (cfg, sig, _, chans), r, tr in zip(specs, res, truths):
        for c, f in enumerate(tr):
            got = float(np.mean(r.carr_freq[c, -500:]))
            log(f"[4] {sig.name} PRN {chans[c][0]}: carrier "
                f"{got:.2f} Hz, truth {f:.2f} Hz")
            check(abs(got - f) < 10.0,
                  f"{sig.name} PRN {chans[c][0]} off by {got - f:.1f} Hz")
    log(f"[4] track_multi L1CA+L5C 2 x 12 ch x 2 s: wall {wall:.1f} s "
        f"(compile included)")


# ---------------------------------------------------------------------------
# --multi
# ---------------------------------------------------------------------------

def run_sharded(seed: int):
    import jax
    from jax.sharding import Mesh
    from cusdr_tpu import get_config
    from cusdr_tpu.acquisition import acquire
    from cusdr_tpu.io.ingest import read_if_file
    from cusdr_tpu.parallel.timeblocks import track_time_parallel
    from cusdr_tpu.signals.defs import get_signal

    import __graft_entry__
    t0 = time.perf_counter()
    __graft_entry__.dryrun_multichip(4)
    log(f"[m] dryrun_multichip(4) ok in {time.perf_counter() - t0:.1f} s")

    path, scn = l1ca_record(seed)
    cfg = get_config("gps_l1ca", file_name=str(path),
                     ms_to_process=TRACK_MS)
    sig = get_signal("gps_l1ca")
    samples = read_if_file(str(path), cfg)
    spc = cfg.samples_per_code
    n_acq = (cfg.acq_non_coh_time + max(cfg.fine_n_codes, 45) + 2) * spc
    acq = acquire(cfg, sig, samples[0:2 * n_acq:2].astype(np.float32)
                  + 1j * samples[1:2 * n_acq:2].astype(np.float32))
    chans = acq.best_channels(cfg.num_channels)
    check(len(chans) % 2 == 0, f"{len(chans)} channels for a 2-wide 'ch'")
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("ch", "tb"))
    res = {}
    for label, m in (("mesh_2x2", mesh), ("one_gpu_flat", None)):
        t0 = time.perf_counter()
        res[label] = track_time_parallel(cfg, sig, samples, chans,
                                         TRACK_MS, 40, mesh=m)
        log(f"[m] track_time_parallel 40 blocks x {len(chans)} ch "
            f"{label}: wall {time.perf_counter() - t0:.1f} s "
            f"(compile included)")
    a, b = res["one_gpu_flat"], res["mesh_2x2"]
    check(np.array_equal(a.abs_sample, b.abs_sample), "abs_sample differs")
    for name in ("carr_freq", "code_freq", "i_p", "q_p"):
        x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        d = float(np.abs(x - y).max() / (np.abs(x).max() + 1.0))
        log(f"[m] sharded vs one-GPU {name}: max diff {d:.3e} of scale")
        check(d < 1e-4, f"sharded {name} differs by {d:.3e}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the sharded paths, on four GPUs")
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    try:
        import cusdr_tpu  # noqa: F401
    except ImportError:
        fail("cusdr_tpu not found: run from the root of a checkout")
    from cusdr_tpu.runtime.cache import enable_persistent_cache
    enable_persistent_cache()

    device = phase_device(4 if args.multi else 1)
    if args.multi:
        run_sharded(args.seed)
    else:
        phase_parity()
        phase_timing(args.seed)
        phase_e2e(args.seed)
        phase_multi_band(args.seed)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
