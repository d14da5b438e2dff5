"""Time-block parallel tracking (the sequence-parallel axis).

The reference processes time strictly sequentially — the per-epoch DLL/PLL
feedback carries remCodePhase/remCarrPhase/NCO state (SURVEY.md §3.3).
Here the IF timeline is split into B blocks tracked CONCURRENTLY
(vmap over a 'tb' mesh axis), in two composable modes:

  * predict (handoff_iters=0): each block's initial channel state is
    propagated open-loop from the acquisition solution — code phase
    advanced at the Doppler-aided code rate, carrier at the acquired
    frequency.  Over block lengths of seconds the prediction error stays
    within the DLL/PLL pull-in range, so each block's closed loop
    re-converges within a short transient (``settle_epochs``), which
    consumers must mask from measurement formation (nav_solve does).

  * state handoff (handoff_iters>=1): after each parallel pass, block
    k+1 restarts from block k's FINAL loop state — a ring shift of the
    state pytree along the 'tb' axis (XLA lowers it to a
    collective-permute when the axis is sharded).  Block 0 always holds
    the true initial state, so after iteration i the first i+1 blocks
    are EXACTLY the sequential trajectory; converged later blocks differ
    only by the loop's exponentially-decayed memory of their predicted
    start, giving sequential-parity within float tolerance at
    handoff_iters=1..2 (tests/test_timeblocks.py pins this).

This plays the structural role ring-attention/Ulysses plays for
attention (SURVEY.md §5): per-channel loop state rides block boundaries
through a ring exchange instead of a serial dependency, turning a 60 s
serial scan into B concurrent scans (× handoff_iters+1 passes).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..signals.defs import SignalDef
from ..tracking.engine import (ChannelState, TrackParams,
                               init_channel_state, make_track_params,
                               track_superblock, TrackResults,
                               TrackOutputs)


def _is_multiprocess(mesh) -> bool:
    return any(d.process_index != jax.process_index()
               for d in mesh.devices.flat)


def _put(x, mesh, spec):
    """device_put for single-process meshes; global-array construction
    when the mesh spans processes (each process feeds its own shards)."""
    from jax.sharding import NamedSharding
    sh = NamedSharding(mesh, spec)
    if _is_multiprocess(mesh):
        xn = np.asarray(x)
        return jax.make_array_from_callback(xn.shape, sh,
                                            lambda idx: xn[idx])
    return jax.device_put(x, sh)


def _fetch(x, mesh):
    """Device array -> host numpy; allgathers across processes so every
    host stitches the same full result."""
    if mesh is not None and _is_multiprocess(mesh):
        from jax.experimental import multihost_utils
        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


@jax.jit
def _ring_shift(states0, final):
    """Block k+1 restarts from block k's final state; block 0 keeps the
    true initial state.  Jitted so it runs as one SPMD program on sharded
    (possibly multi-process) 'tb' axes — a collective-permute between
    devices when sharded."""
    return jax.tree.map(
        lambda i0, fin: jnp.concatenate([i0[:1], fin[:-1]], axis=0),
        states0, final)


@functools.partial(jax.jit, static_argnames=("params", "n_epochs"))
def _track_blocks(samples_blocks, block_starts, block_ends, code_tables,
                  pilot_tables, states: ChannelState,
                  params: TrackParams, n_epochs: int):
    """vmap of track_superblock over the block axis.

    samples_blocks: [B, S_blk] uint16 packed (int8 I low byte / Q high
    byte) or [B, 2*S_blk] int8 interleaved; block_starts/block_ends: [B] i64 (absolute sample
    range of each block's buffer); states: leaves [B, C].
    """
    def one(samples, start, end, st):
        return track_superblock(samples, start, code_tables, pilot_tables,
                                st, params, n_epochs, end)

    return jax.vmap(one)(samples_blocks, block_starts, block_ends, states)


@functools.partial(jax.jit,
                   static_argnames=("params", "n_epochs", "n_blocks"))
def _track_blocks_flat(samples_iq, code_tables, pilot_tables,
                       states: ChannelState, params: TrackParams,
                       n_epochs: int, n_blocks: int):
    """Single-device fast path: the B concurrent blocks become ONE
    B·C-row channel bank over the full record — abs_sample already
    positions every block, the GPU correlator kernel (ops/correlator.py)
    reads each window straight from the record and shares the replica
    tables across blocks by row modulo, and no per-block sample buffers
    are materialized.  The XLA epoch maps rows to tables one to one, so
    it gets the tables tiled B times.

    samples_iq: [S] uint16 packed (preferred) or [2S] int8 full record;
    states
    leaves [B, C].
    Returns (states [B, C], outputs [B, n_epochs, C]).
    """
    B = n_blocks
    C = states.abs_sample.shape[1]
    if not (params.use_pallas and params.fast_code):
        code_tables = jnp.tile(code_tables,
                               (B,) + (1,) * (code_tables.ndim - 1))
        pilot_tables = jnp.tile(pilot_tables,
                                (B,) + (1,) * (pilot_tables.ndim - 1))
    flat = jax.tree.map(
        lambda x: x.reshape((B * C,) + x.shape[2:]), states)
    st, outs = track_superblock(samples_iq, jnp.int64(0), code_tables,
                                pilot_tables, flat, params, n_epochs)
    st = jax.tree.map(lambda x: x.reshape((B, C) + x.shape[1:]), st)
    outs = jax.tree.map(
        lambda x: jnp.transpose(x.reshape(x.shape[0], B, C), (1, 0, 2)),
        outs)
    return st, outs



def _track_blocks_shardmap(mesh, sb_np, sb_start_np, sb_end_np,
                           code_tables, pilot_tables,
                           states0_np, params: TrackParams,
                           n_epochs: int, handoff_iters: int,
                           blk_len: int):
    """Sharded time-block tracking via shard_map: each 'tb' shard runs
    its local blocks as ONE flat B_loc*C-row bank over a per-shard
    pseudo-record (its block buffers concatenated), exactly like the
    single-device flat path.

    Inside shard_map the body is unvmapped, so each shard runs the
    correlator kernel on its own flat bank and the program compiles
    once (a vmapped per-block program compiles the block body B times).

    Block b of a shard's local buffer lives at pseudo-record offset
    b*blk_len; channel offsets are remapped by adjusting abs_sample
    (and unmapped on the way out).  The ring handoff between passes
    stays a global (cross-shard) concatenate outside the shard_map.
    """
    from functools import partial
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    ch_ax = "ch" if "ch" in mesh.axis_names else None
    state_spec = jax.tree.map(
        lambda x: P(*(("tb", ch_ax) + (None,) * (x.ndim - 2))),
        states0_np)
    tab_spec = P(*((ch_ax,) + (None,) * (code_tables.ndim - 1)))

    @partial(shard_map, mesh=mesh,
             in_specs=(P("tb", None), P("tb"), P("tb"), tab_spec,
                       tab_spec, state_spec),
             out_specs=(state_spec, P("tb", None, ch_ax)),
             check_vma=False)
    def body(sb, sb_start, sb_end, ct, pt, st):
        b_loc = sb.shape[0]
        c_loc = st.carr_freq.shape[1]
        rec = sb.reshape(b_loc * sb.shape[1])    # per-shard pseudo-record
        if not (params.use_pallas and params.fast_code):
            # the XLA epoch vmaps rows against tables 1:1 — tile the
            # c_loc-row tables to the b_loc*c_loc flat rows (the kernel
            # instead shares tables by row modulo)
            ct = jnp.tile(ct, (b_loc,) + (1,) * (ct.ndim - 1))
            pt = jnp.tile(pt, (b_loc,) + (1,) * (pt.ndim - 1))
        # pseudo-record offset of each local block
        offs = sb_start - jnp.arange(b_loc, dtype=jnp.int64) * blk_len
        st = st._replace(abs_sample=st.abs_sample - offs[:, None])
        end_rows = jnp.broadcast_to((sb_end - offs)[:, None],
                                    (b_loc, c_loc))
        flat = jax.tree.map(
            lambda x: x.reshape((b_loc * c_loc,) + x.shape[2:]), st)
        stf, outs = track_superblock(rec, jnp.int64(0), ct, pt, flat,
                                     params, n_epochs,
                                     end_rows.reshape(-1))
        stf = jax.tree.map(
            lambda x: x.reshape((b_loc, c_loc) + x.shape[1:]), stf)
        stf = stf._replace(abs_sample=stf.abs_sample + offs[:, None])
        outs = jax.tree.map(
            lambda x: jnp.transpose(
                x.reshape(x.shape[0], b_loc, c_loc), (1, 0, 2)), outs)
        outs = outs._replace(
            abs_sample=outs.abs_sample + offs[:, None, None])
        return stf, outs

    sh = lambda x, spec: _put(x, mesh, spec)
    sb_d = sh(sb_np, P("tb", None))
    starts_d = sh(sb_start_np, P("tb"))
    ends_d = sh(sb_end_np, P("tb"))
    ct_d = sh(np.asarray(code_tables), tab_spec)
    pt_d = sh(np.asarray(pilot_tables), tab_spec)
    # NOTE: PartitionSpec is a tuple subclass, so a pytree of specs
    # cannot ride through jax.tree.map alongside the state tree —
    # rebuild each leaf's spec from its rank instead
    states0 = jax.tree.map(
        lambda x: sh(np.asarray(x),
                     P(*(("tb", ch_ax) + (None,) * (x.ndim - 2)))),
        states0_np)

    states = states0
    outs = None
    for it in range(handoff_iters + 1):
        final, outs = body(sb_d, starts_d, ends_d, ct_d, pt_d, states)
        if it < handoff_iters:
            states = _ring_shift(states0, final)
    return states, final, outs


def predict_block_states(channels: Sequence, cfg, sig: SignalDef,
                         n_blocks: int, epochs_per_block: int):
    """Open-loop state prediction for each block start.

    Returns (states with leaves [B, C], block first-epoch sample offsets
    [B, C] as int64).
    """
    fs = cfg.sampling_freq
    code_len = sig.code_length_chips
    if_offsets = np.zeros(len(channels))
    if sig.fdma:
        if_offsets = np.asarray([sig.fdma_spacing_hz * ch[0]
                                 for ch in channels])
    dopplers = (np.asarray([ch[1] for ch in channels])
                - cfg.if_freq - if_offsets)
    code_freqs = sig.chip_rate_hz * (1.0 + dopplers / sig.carrier_freq_hz)
    phase0 = np.asarray([ch[2] for ch in channels], np.float64)

    starts = np.zeros((n_blocks, len(channels)), np.int64)
    rems = np.zeros((n_blocks, len(channels)), np.float64)
    for b in range(n_blocks):
        # chips elapsed by this block's first epoch
        chips = b * epochs_per_block * code_len
        # sample position where that code period starts
        pos = phase0 + chips * (fs / code_freqs)
        starts[b] = np.ceil(pos).astype(np.int64)
        # rem_code_phase convention (tracking.m:273): fractional chips
        # already elapsed at the integer start sample
        rems[b] = (starts[b] - pos) * (code_freqs / fs)
    base = init_channel_state(channels, sig.chip_rate_hz,
                              dopplers=dopplers,
                              carrier_freq_hz=sig.carrier_freq_hz)
    mod = max(getattr(sig, "pilot_phase_hypotheses", 0), 1)
    leaves = []
    for b in range(n_blocks):
        pper = (np.asarray(base.pilot_period)
                + b * epochs_per_block) % mod
        st = base._replace(
            abs_sample=jnp.asarray(starts[b]),
            rem_code_phase=jnp.asarray(rems[b]),
            pilot_period=jnp.asarray(pper.astype(np.int32)))
        leaves.append(st)
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *leaves)
    return stacked, starts


def track_time_parallel(cfg, sig: SignalDef, samples_iq: np.ndarray,
                        channels: Sequence, n_epochs: int,
                        n_blocks: int,
                        settle_epochs: Optional[int] = None,
                        handoff_iters: Optional[int] = None,
                        mesh=None) -> TrackResults:
    """Track ``n_epochs`` split into ``n_blocks`` concurrent time blocks.

    With ``mesh`` (axis 'tb'), the block axis is sharded across devices;
    without, vmap still executes all blocks in one fused program.
    ``handoff_iters`` parallel passes re-seed each block from its left
    neighbor's final state (module docstring); at 0, per-block transients
    are flagged via ``settle_epochs``/``epochs_per_block`` on the result
    and nav_solve masks them.
    """
    params = make_track_params(cfg, sig)
    spc = cfg.samples_per_code
    if settle_epochs is None:
        settle_epochs = cfg.settle_epochs
    if handoff_iters is None:
        handoff_iters = cfg.handoff_iters
    epochs_per_block = n_epochs // n_blocks
    assert epochs_per_block * n_blocks == n_epochs

    states0, starts = predict_block_states(channels, cfg, sig, n_blocks,
                                           epochs_per_block)
    # single-device kernel path: all blocks as ONE flat channel bank
    # over the full record — no per-block sample buffers
    samples_iq = np.ascontiguousarray(samples_iq)
    use_flat = mesh is None and params.use_pallas
    if samples_iq.dtype == np.int8:
        # packed uint16: free host deinterleave (engine docstring);
        # eps = buffer elements per complex sample
        samples_h, eps = samples_iq.view(np.uint16), 1
    else:
        samples_h, eps = samples_iq, 2            # interleaved int16
    total = len(samples_iq) // 2
    if not use_flat:
        # per-block sample windows: one code period of FRONT margin
        # (handoff may move a block's start slightly before its
        # predicted start) and tail margin
        blk_len = (epochs_per_block + 4) * spc + params.blk + 256
        sb = np.zeros((n_blocks, eps * blk_len), samples_h.dtype)
        sb_start = np.zeros(n_blocks, np.int64)
        sb_end = np.zeros(n_blocks, np.int64)
        for b in range(n_blocks):
            s0 = max(int(starts[b].min()) - spc, 0)
            s1 = min(s0 + blk_len, total)
            sb_start[b] = s0
            sb_end[b] = s1
            sb[b, :eps * (s1 - s0)] = samples_h[eps * s0:eps * s1]

    if_offsets0 = np.zeros(len(channels))
    if sig.fdma:
        if_offsets0 = np.asarray([sig.fdma_spacing_hz * ch[0]
                                  for ch in channels])
    dopplers0 = (np.asarray([ch[1] for ch in channels], np.float64)
                 - cfg.if_freq - if_offsets0)
    if params.fast_code:
        from ..tracking.engine import build_replica_tables
        ctabs, ptabs = build_replica_tables(cfg, sig, params, channels,
                                            dopplers0)
    else:
        from ..tracking.engine import build_element_tables
        ctabs, ptabs = build_element_tables(cfg, sig, params, channels)

    states = states0
    ct_d, pt_d = jnp.asarray(ctabs), jnp.asarray(ptabs)
    if use_flat:
        samples_d = jnp.asarray(samples_h)
        outs = None
        for it in range(handoff_iters + 1):
            final, outs = _track_blocks_flat(samples_d, ct_d, pt_d,
                                             states, params,
                                             epochs_per_block, n_blocks)
            if it < handoff_iters:
                states = _ring_shift(states0, final)
        return _stitch(cfg, sig, channels, n_blocks, epochs_per_block,
                       handoff_iters, settle_epochs, states, final,
                       outs, mesh)

    if mesh is not None:
        # sharded path: shard_map over 'tb' — each shard runs its local
        # blocks as one flat bank over a per-shard pseudo-record
        states, final, outs = _track_blocks_shardmap(
            mesh, sb, sb_start, sb_end, ctabs, ptabs, states, params,
            epochs_per_block, handoff_iters, blk_len)
        return _stitch(cfg, sig, channels, n_blocks, epochs_per_block,
                       handoff_iters, settle_epochs, states, final,
                       outs, mesh)

    sb_d = jnp.asarray(sb)
    starts_d = jnp.asarray(sb_start)
    ends_d = jnp.asarray(sb_end)
    outs = None
    for it in range(handoff_iters + 1):
        final, outs = _track_blocks(sb_d, starts_d, ends_d, ct_d, pt_d,
                                    states, params, epochs_per_block)
        if it < handoff_iters:
            states = _ring_shift(states0, final)
    return _stitch(cfg, sig, channels, n_blocks, epochs_per_block,
                   handoff_iters, settle_epochs, states, final, outs,
                   mesh)


def _stitch(cfg, sig, channels, n_blocks, epochs_per_block,
            handoff_iters, settle_epochs, states, final, outs, mesh):
    # ---- Costas 180° sign resolution across block boundaries --------------
    # A block's lock sign is ambiguous: it ran from an open-loop predicted
    # phase (predict mode) or its left neighbor's PREVIOUS-pass final
    # state (handoff) — either way the Costas loop may settle π away from
    # its neighbor, inverting every correlator output of the block and
    # breaking the stitched nav-bit stream (LNAV parity / Viterbi) at the
    # boundary.  A locked loop holds the NCO within ~0 or ~π of the true
    # carrier, so the phase discrepancy at each boundary — block k's
    # final-pass end phase vs the start phase block k+1 actually used,
    # propagated over any small sample offset — resolves the relative
    # sign; cumulative products re-sign every block onto block 0's
    # (true) sign.
    if n_blocks > 1:
        fs = cfg.sampling_freq
        fin_phi = _fetch(final.rem_carr_phase, mesh)    # [B, C] rad
        fin_s = _fetch(final.abs_sample, mesh).astype(np.float64)
        fin_f = _fetch(final.carr_freq, mesh)
        st_phi = _fetch(states.rem_carr_phase, mesh)
        st_s = _fetch(states.abs_sample, mesh).astype(np.float64)
        dphi = (fin_phi[:-1] - st_phi[1:]
                + 2.0 * np.pi * fin_f[:-1] * (st_s[1:] - fin_s[:-1]) / fs)
        rel = np.where(np.cos(dphi) < 0.0, -1.0, 1.0)      # [B-1, C]
        signs = np.concatenate(
            [np.ones((1, rel.shape[1])), np.cumprod(rel, axis=0)],
            axis=0).astype(np.float32)                     # [B, C]
    else:
        signs = None

    _SIGNED = {"i_e", "q_e", "i_p", "q_p", "i_l", "q_l", "pilot_ip", "pilot_qp"}
    # outs leaves: [B, epochs_per_block, C] -> [C, B*epochs_per_block]
    merged = {}
    for name in TrackOutputs._fields:
        v = _fetch(getattr(outs, name), mesh)
        if signs is not None and name in _SIGNED:
            v = v * signs[:, None, :]
        merged[name] = np.concatenate(list(v), axis=0).T
    res = TrackResults([ch[0] for ch in channels], merged, cfg)
    res.n_blocks = n_blocks
    res.epochs_per_block = epochs_per_block
    # exact-stitched results have no transient to mask
    res.settle_epochs = 0 if handoff_iters >= 1 else settle_epochs
    return res
