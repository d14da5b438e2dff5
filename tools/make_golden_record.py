#!/usr/bin/env python
"""Generate a reference-workload golden IF recording + truth sidecar.

Produces the L1CA default workload of the reference
(GPS/GPS_L1CA/initSettings.m:44-70): 18 Msps complex int8 I/Q, 20 kHz
IF, N seconds, a geometrically consistent multi-SV scene with LNAV
ephemerides — the synthetic stand-in for the reference's recorded data
sets (README.md:11-13), used for the on-hardware end-to-end regression:

    python tools/make_golden_record.py --out .cache/l1_golden --sec 61
    python -m cusdr_tpu run --signal gps_l1ca --file .cache/l1_golden.bin \
        --time-blocks 40 --out .cache/l1_out

The record is synthesized in one worker process per CPU core
(io/synth.synthesize_iq_int8).
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=".cache/l1_golden")
    ap.add_argument("--sec", type=float, default=61.0)
    ap.add_argument("--fs", type=float, default=18e6)
    ap.add_argument("--if-freq", type=float, default=20e3)
    ap.add_argument("--n-svs", type=int, default=6)
    ap.add_argument("--cn0", type=float, default=46.0)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()

    from cusdr_tpu import get_config
    from cusdr_tpu.io.scenario import make_gps_scenario
    from cusdr_tpu.io.synth import synthesize_iq_int8
    from cusdr_tpu.signals.defs import get_signal

    cfg = get_config("gps_l1ca", sampling_freq=args.fs,
                     if_freq=args.if_freq)
    sig = get_signal("gps_l1ca")
    t0 = time.time()
    scn = make_gps_scenario(cfg, sig, n_svs=args.n_svs,
                            duration_s=args.sec, cn0_dbhz=args.cn0)
    num_ms = int(args.sec * 1000.0) + 500
    print(f"synthesizing {num_ms} ms at {args.fs/1e6:.1f} Msps, "
          f"{args.n_svs} SVs...", flush=True)
    iq = synthesize_iq_int8(cfg, sig, scn.svs, num_ms=num_ms,
                            seed=args.seed, workers=os.cpu_count() or 1)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    iq.tofile(str(out) + ".bin")
    truth = {
        "rx_ecef": [float(x) for x in scn.rx_ecef],
        "rx_llh": [float(x) for x in scn.rx_llh],
        "prns": [sv.prn for sv in scn.svs],
        "fs": args.fs, "if_freq": args.if_freq,
        "num_ms": num_ms, "cn0_dbhz": args.cn0,
    }
    with open(str(out) + ".json", "w") as f:
        json.dump(truth, f, indent=1)
    print(f"wrote {out}.bin ({iq.nbytes/1e9:.2f} GB) + {out}.json "
          f"in {time.time()-t0:.0f}s")


if __name__ == "__main__":
    main()
