"""Concurrent multi-signal tracking — the constellation/EP axis.

The reference is 12 independent sibling receivers, one process per
signal (SURVEY.md §2.3): processing GPS+GAL+BDS+GLO means 12 serial
MATLAB runs.  Here the signal banks are scheduled TOGETHER inside one
XLA program on a common subepoch clock (SURVEY.md §7 hard part 3):

  * each signal keeps its own IF record (multi-band front ends — one
    recording per band, /root/reference/README.md:11-13), replica
    tables, TrackParams and ChannelState bank;
  * one *hyperepoch* spans the least common multiple of the signals'
    code periods (e.g. L1CA 1 ms + E1C 4 ms -> 4 ms); within it each
    bank statically unrolls its own epochs (4 L1CA, 1 E1C), so the
    mixed 1/4/10/20 ms integration grid (SURVEY.md §2.3) needs no
    data-dependent control flow — `lax.scan` runs over hyperepochs and
    XLA schedules all banks' kernels inside one dispatch;
  * per-bank state/tables can be sharded over a mesh 'ch' axis exactly
    like the single-signal bank (parallel/mesh.py) — GSPMD partitions
    every bank's epoch over the same devices.

This turns the reference's "run 12 receivers one after another" into
one device-resident program per superblock — the EP-analog of expert
parallelism, with signals as the experts.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .engine import (ChannelState, TrackResults,
                     _finish_bank, _prepare_bank, build_element_tables,
                     build_replica_tables, init_channel_state,
                     make_track_params)


class BankInputs(NamedTuple):
    """Device-side inputs of one signal's channel bank (pytree)."""
    samples: jnp.ndarray        # [S] uint16 packed or [2S] int8/int16
    sb_start: jnp.ndarray       # i64 scalar
    code_tables: jnp.ndarray
    pilot_tables: jnp.ndarray
    state: ChannelState
    end_sample: Optional[jnp.ndarray] = None


@functools.partial(jax.jit,
                   static_argnames=("params_list", "strides", "n_hyper"))
def track_superblock_multi(banks, params_list, strides, n_hyper: int):
    """Advance every bank through ``n_hyper`` hyperepochs in ONE program.

    banks: tuple of BankInputs; params_list: matching tuple of
    TrackParams (static); strides: epochs per hyperepoch per bank
    (static, = hyper_period / bank code period).
    Returns tuple of (new_state, TrackOutputs [n_hyper*stride, C]).
    """
    steps = [_prepare_bank(b.samples, b.sb_start, b.code_tables,
                           b.pilot_tables, b.state, p, b.end_sample)
             for b, p in zip(banks, params_list)]
    states0 = tuple(b.state for b in banks)

    def body(states, _):
        new_states, outs = [], []
        for st, step, stride in zip(states, steps, strides):
            per = []
            for _ in range(stride):          # static unroll
                st, o = step(st)
                per.append(o)
            new_states.append(st)
            # [stride, 12|4|2, C] per packed dtype group
            outs.append(tuple(jnp.stack(g)
                              for g in zip(*per)))
        return tuple(new_states), tuple(outs)

    final, scanned = jax.lax.scan(body, states0, None, length=n_hyper)
    results = []
    for st, (o32, o64, oi) in zip(final, scanned):
        # [n_hyper, stride, G, C] -> [n_hyper*stride, G, C]
        flat = tuple(x.reshape((-1,) + x.shape[2:])
                     for x in (o32, o64, oi))
        results.append(_finish_bank(st, flat))
    return tuple(results)


def _hyper_grid(sigs) -> tuple:
    """Common clock: (hyper_period_ms, per-signal strides)."""
    periods = [int(round(s.code_period_ms)) for s in sigs]
    for p, s in zip(periods, sigs):
        if abs(p - s.code_period_ms) > 1e-9:
            raise ValueError(f"{s.name}: non-integer-ms code period")
    hyper = periods[0]
    for p in periods[1:]:
        hyper = hyper * p // math.gcd(hyper, p)
    return hyper, tuple(hyper // p for p in periods)


def track_multi(specs: Sequence, n_ms: Optional[int] = None,
                mesh=None) -> list:
    """Track several signals' channel banks concurrently.

    specs: sequence of (cfg, sig, samples_iq, channels) — one entry per
    signal, each with its own IF record (bands are recorded separately;
    the records need not share fs or length).  channels as in
    tracking.track.  n_ms: common processing span in milliseconds
    (default: largest span all records allow).  With ``mesh`` (axis
    'ch'), every bank's channel axis is sharded across the mesh.

    Returns a list of TrackResults, one per signal, each identical to
    what a standalone tracking.track run over the same span produces
    (tests/test_multi_signal_track.py pins this).
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    sigs = [sp[1] for sp in specs]
    hyper_ms, strides = _hyper_grid(sigs)

    banks, params_list, cfgs, limits = [], [], [], []
    for (cfg, sig, samples_iq, channels), stride in zip(specs, strides):
        params = make_track_params(cfg, sig)
        samples_iq = np.ascontiguousarray(np.asarray(samples_iq))
        if samples_iq.dtype == np.int8:
            s16 = samples_iq.view(np.uint16)   # packed (engine docstring)
        else:
            s16 = samples_iq                   # interleaved int16
        total = len(samples_iq) // 2
        if_off = np.zeros(len(channels))
        if sig.fdma:
            if_off = np.asarray([sig.fdma_spacing_hz * ch[0]
                                 for ch in channels])
        dops = (np.asarray([ch[1] for ch in channels], np.float64)
                - cfg.if_freq - if_off)
        if params.fast_code:
            ct, pt = build_replica_tables(cfg, sig, params, channels,
                                          dops)
        else:
            ct, pt = build_element_tables(cfg, sig, params, channels)
        state = init_channel_state(channels, sig.chip_rate_hz,
                                   dopplers=dops,
                                   carrier_freq_hz=sig.carrier_freq_hz)
        spc = cfg.samples_per_code
        max_phase = max(ch[2] for ch in channels)
        limits.append((total - max_phase - 2 * spc) // spc
                      * sig.code_period_ms)
        ct_d, pt_d = jnp.asarray(ct), jnp.asarray(pt)
        state_d = state
        if mesh is not None:
            shc = NamedSharding(mesh, P("ch"))
            state_d = jax.tree.map(
                lambda x: jax.device_put(x, shc), state)
            ct_d = jax.device_put(
                ct_d, NamedSharding(
                    mesh, P(*(("ch",) + (None,) * (ct_d.ndim - 1)))))
            pt_d = jax.device_put(
                pt_d, NamedSharding(
                    mesh, P(*(("ch",) + (None,) * (pt_d.ndim - 1)))))
        banks.append(BankInputs(jnp.asarray(s16), jnp.int64(0),
                                ct_d, pt_d, state_d,
                                jnp.int64(total)))
        params_list.append(params)
        cfgs.append(cfg)

    if n_ms is None:
        n_ms = int(min(limits))
    n_hyper = int(n_ms) // hyper_ms
    if n_hyper < 1:
        raise ValueError(f"n_ms={n_ms} below one {hyper_ms} ms hyperepoch")

    results = track_superblock_multi(tuple(banks), tuple(params_list),
                                     strides, n_hyper)
    out = []
    for (cfg, _, _, channels), (st, touts) in zip(specs, results):
        merged = {f: np.asarray(getattr(touts, f)).T
                  for f in touts._fields}
        out.append(TrackResults([ch[0] for ch in channels], merged, cfg))
    return out
