"""CLI driver — the init.m / postProcessing.m equivalent.

Examples:
  python -m cusdr_tpu probe  --signal gps_l1ca --file L1.bin
  python -m cusdr_tpu run    --signal gps_l1ca --file L1.bin --out out/
  python -m cusdr_tpu run    --signal bds_b1i  --file B1I.bin \
         --ms 40000 --skip-acquisition out/acq.npz
  python -m cusdr_tpu signals
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def _apply_platform(platform=None):
    """Select the JAX platform (--platform) before any device is used."""
    if platform:
        import jax
        jax.config.update("jax_platforms", platform)


def _add_common(p):
    p.add_argument("--signal", default="gps_l1ca",
                   help="signal key (see `signals` command)")
    p.add_argument("--file", required=True, help="IF sample file")
    p.add_argument("--fs", type=float, help="override sampling freq [Hz]")
    p.add_argument("--if-freq", type=float, help="override IF [Hz]")
    p.add_argument("--ms", type=int, help="ms to process")
    p.add_argument("--skip-bytes", type=int, default=0)
    p.add_argument("--prns", help="comma-separated PRN (or FDMA channel) "
                                  "search list (setSettings.m:191-196)")
    p.add_argument("--acq-threshold", type=float,
                   help="override acquisition threshold")
    p.add_argument("--file-type", type=int, choices=(1, 2),
                   help="1 = real samples, 2 = interleaved I/Q "
                        "(initSettings.m:62-65)")
    p.add_argument("--data-type", choices=("schar", "int16"),
                   help="sample scalar type (initSettings.m:61)")
    p.add_argument("--platform", default=None,
                   help="force the JAX platform (cpu/gpu); default = "
                        "JAX_PLATFORMS env, else the installed backend")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="cusdr_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("probe", help="pre-flight data checks (probeData.m)")
    _add_common(p)
    p.add_argument("--out", default="probe.png")

    p = sub.add_parser("run", help="full pipeline (postProcessing.m)")
    _add_common(p)
    p.add_argument("--out", default="out", help="output directory")
    p.add_argument("--skip-acquisition", metavar="ACQ_NPZ",
                   help="reuse a saved acquisition checkpoint")
    p.add_argument("--no-plots", action="store_true")
    p.add_argument("--profile", metavar="TRACE_DIR", default=None,
                   help="capture a jax.profiler device trace of the "
                        "tracking stage into this directory")
    p.add_argument("--timing", action="store_true",
                   help="print the per-stage timing table at the end")
    p.add_argument("--time-blocks", type=int, default=None,
                   help="track this many concurrent time blocks "
                        "(sequence-parallel axis; 0/1 = sequential)")
    p.add_argument("--handoff-iters", type=int, default=None,
                   help="time-parallel ring state-handoff rounds")
    p.add_argument("--pilot-trk-flag", type=int, choices=(0, 1, 2),
                   default=None,
                   help="0 = data only, 1 = data+pilot (B1C: NB), "
                        "2 = B1C wideband QMBOC")
    p.add_argument("--lock-detect", dest="lock_detect",
                   action="store_true", default=None,
                   help="drop channels on PLL loss of lock "
                        "(tracking.m:241-245 lifecycle; default on)")
    p.add_argument("--no-lock-detect", dest="lock_detect",
                   action="store_false")
    p.add_argument("--use-pallas", dest="use_pallas",
                   action="store_true", default=None,
                   help="require the fused correlator kernel (an error "
                        "off the GPU; default: the kernel on GPU, the "
                        "XLA epoch elsewhere)")
    p.add_argument("--no-pallas", dest="use_pallas", action="store_false",
                   help="run the XLA epoch even on the GPU")

    p = sub.add_parser("run-multi",
                       help="concurrent multi-signal pipeline (the "
                            "constellation/EP axis): every signal's "
                            "channel bank tracked in ONE device program")
    p.add_argument("--set", action="append", required=True,
                   metavar="SIGNAL=FILE", dest="sets",
                   help="signal preset and its IF recording; repeatable "
                        "(bands are recorded separately, one file per "
                        "signal as in the reference data sets)")
    p.add_argument("--ms", type=int, help="common ms span to process")
    p.add_argument("--out", default="out", help="output directory")
    p.add_argument("--platform", default=None)

    sub.add_parser("signals", help="list registered signals")

    args = ap.parse_args(argv)
    _apply_platform(getattr(args, "platform", None))
    from .runtime.cache import enable_persistent_cache
    enable_persistent_cache()

    if args.cmd == "signals":
        from .config import PRESETS
        from .signals.defs import REGISTRY
        for k in sorted(PRESETS):
            sig = REGISTRY[k]
            print(f"{k:10s}  {sig.chip_rate_hz / 1e6:6.3f} Mcps x "
                  f"{sig.code_length_chips:6d} chips  codec={sig.nav_codec}")
        return 0

    if args.cmd == "run-multi":
        from pathlib import Path as _P
        from .config import get_config
        from . import checkpoint
        from .receiver import run_multi
        out = _P(args.out)
        out.mkdir(parents=True, exist_ok=True)
        entries = []
        for item in args.sets:
            name, _, path = item.partition("=")
            if not path:
                print(f"--set needs SIGNAL=FILE, got {item!r}")
                return 2
            cfg = get_config(name, file_name=path,
                             **({"ms_to_process": args.ms}
                                if args.ms else {}))
            entries.append((cfg, None))
        results = run_multi(entries, n_ms=args.ms)
        rc = 1
        for (cfg, _), res in zip(entries, results):
            tag = cfg.signal
            if not res.channels:
                print(f"{tag}: no signals detected")
                continue
            rc = 0
            checkpoint.save_tracking(out / f"trk_{tag}.npz", res.track)
            prns = ",".join(str(p) for p, *_ in res.channels)
            msg = f"{tag}: {len(res.channels)} channels (PRN {prns})"
            if res.nav is not None and len(res.nav.X):
                checkpoint.save_navigation(out / f"nav_{tag}.npz",
                                           res.nav)
                msg += (f", {len(res.nav.X)} fixes, mean lat="
                        f"{np.mean(res.nav.latitude):.6f} lon="
                        f"{np.mean(res.nav.longitude):.6f}")
            print(msg)
        return rc

    from .config import get_config
    over = {}
    if args.fs:
        over["sampling_freq"] = args.fs
    if args.if_freq is not None:
        over["if_freq"] = args.if_freq
    if args.ms:
        over["ms_to_process"] = args.ms
    if args.prns:
        over["acq_satellite_list"] = tuple(
            int(x) for x in args.prns.split(","))
    if args.acq_threshold is not None:
        over["acq_threshold"] = args.acq_threshold
    if args.file_type is not None:
        over["file_type"] = args.file_type
    if args.data_type is not None:
        over["data_type"] = args.data_type
    for name in ("time_blocks", "handoff_iters", "pilot_trk_flag",
                 "lock_detect", "use_pallas"):
        v = getattr(args, name, None)
        if v is not None:
            over[name] = v
    over["skip_number_of_bytes"] = args.skip_bytes
    over["file_name"] = args.file
    cfg = get_config(args.signal, **over)

    from .io.ingest import read_if_file
    samples = read_if_file(args.file, cfg)

    if args.cmd == "probe":
        from .io.ingest import load_if_samples
        from .plotting import probe_data
        sig_samples = load_if_samples(args.file, cfg,
                                      num_samples=int(cfg.sampling_freq
                                                      * 0.01))
        fig = probe_data(sig_samples, cfg)
        fig.savefig(args.out, dpi=110)
        print(f"probe written to {args.out}")
        return 0

    # ---- run ---------------------------------------------------------------
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    from . import checkpoint
    from .plotting import show_channel_status
    from .receiver import Receiver, nav_solve
    from .signals.defs import get_signal
    from .tracking import track

    from .runtime.profiling import StageTimer, device_trace

    sig = get_signal(cfg.signal)
    rx = Receiver(cfg)
    timer = StageTimer(sampling_freq=cfg.sampling_freq)
    t0 = time.time()

    if args.skip_acquisition:
        acq = checkpoint.load_acquisition(args.skip_acquisition)
        print(f"acquisition reused from {args.skip_acquisition}")
    else:
        from .acquisition import acquire
        spc = cfg.samples_per_code
        n_coh = max(1, int(round(cfg.acq_coh_time
                                 / max(sig.code_period_ms, 1e-9))))
        n_acq = (cfg.acq_non_coh_time * n_coh
                 + max(cfg.fine_n_codes, 45) + 2) * spc
        acq_sig = (samples[0:2 * n_acq:2].astype(np.float32)
                   + 1j * samples[1:2 * n_acq:2].astype(np.float32))
        with timer.stage("acquisition", samples=n_acq):
            acq = acquire(cfg, sig, acq_sig)
        checkpoint.save_acquisition(out / "acqResults.npz", acq)
        print(f"acquisition done in {time.time() - t0:.1f}s -> "
              f"{out / 'acqResults.npz'}")

    channels = acq.best_channels(cfg.num_channels)
    if not channels:
        print("no signals detected — exiting (postProcessing.m:108-117)")
        return 1
    print(show_channel_status(channels, acq, cfg))

    t0 = time.time()
    n_epochs = int(cfg.ms_to_process / sig.code_period_ms) \
        if cfg.ms_to_process else None
    with device_trace(args.profile), \
            timer.stage("tracking", samples=len(samples) // 2):
        if cfg.time_blocks > 1:
            from .parallel.timeblocks import track_time_parallel
            spc = cfg.samples_per_code
            if n_epochs is None:
                max_phase = max(ch[2] for ch in channels)
                n_epochs = int((len(samples) // 2 - max_phase
                                - 2 * spc) // spc)
            n_epochs = (n_epochs // cfg.time_blocks) * cfg.time_blocks
            trk = track_time_parallel(cfg, sig, samples, channels,
                                      n_epochs, cfg.time_blocks)
        else:
            trk = track(cfg, sig, samples, channels, n_epochs=n_epochs)
    checkpoint.save_tracking(out / "trkResults.npz", trk)
    print(f"tracking done in {time.time() - t0:.1f}s -> "
          f"{out / 'trkResults.npz'}")

    t0 = time.time()
    with timer.stage("navigation"):
        nav = nav_solve(cfg, sig, trk)
    if nav is None:
        print("no navigation solution (too few decoded channels)")
    else:
        checkpoint.save_navigation(out / "navResults.npz", nav)
        lat, lon, h = (np.mean(nav.latitude), np.mean(nav.longitude),
                       np.mean(nav.height))
        print(f"PVT done in {time.time() - t0:.1f}s: {len(nav.X)} fixes, "
              f"mean lat={lat:.6f} lon={lon:.6f} h={h:.1f} m")

    if not args.no_plots:
        from .plotting import (plot_acquisition, plot_navigation,
                               plot_tracking, sky_plot)
        plot_acquisition(acq).savefig(out / "acquisition.png", dpi=110)
        for ch in range(len(channels)):
            plot_tracking(trk, ch, cfg).savefig(
                out / f"tracking_ch{ch}.png", dpi=100)
        if nav is not None:
            plot_navigation(nav).savefig(out / "navigation.png", dpi=110)
            sky_plot(nav, trk.prns).savefig(out / "skyplot.png", dpi=110)
        print(f"plots written to {out}/")
    if args.timing:
        print(timer.report())
    if args.profile:
        print(f"device trace written to {args.profile} "
              f"(view with tensorboard/xprof)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
