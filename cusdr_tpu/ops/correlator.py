"""Fused epoch-correlator kernel for NVIDIA GPUs (Pallas, Triton route).

One program per (channel row, sample chunk) reads its channel's sample
window straight from the record and its replica windows straight from
the replica tables, at dynamic offsets.  A loop inside the program walks
the chunk in ``TILE``-sample tiles: int → f32 conversion, carrier
wipe-off, sub-sample replica interpolation of the E/P/L taps, valid-
sample masking, and accumulation of the correlator sums in registers.
Nothing per-sample is written back to device memory; only the int8
samples and replica bytes are read.

Each program writes its partial sums for its chunk; a second pass (XLA)
adds the chunks.  No atomics, so results are deterministic.

The carrier is factorised per tile as e^{-j2π(φ_t + f·l)} = u_t · v_l
with l the lane within the tile: the caller evaluates u (one value per
tile) and v (one ``TILE`` vector per channel) from float64 phases, so
every per-sample carrier value is accurate to f32 rounding whatever the
record length or IF, and the loop body holds no transcendental.

Reference semantics: the six correlator sums of
GPS/GPS_L1CA/include/tracking.m:280-300 (carrier wipe-off + dot
products), plus the raw (unrotated) pilot correlators of the data+pilot
receivers (GPS_L5C/include/tracking.m:334-345); the caller applies the
pilot's quarter-turn rotation and the dual-bank combine to the sums.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

TILE = 512              # samples per inner-loop tile (power of two)
NUM_WARPS = 4           # TILE / (32 * NUM_WARPS) = 4 samples per thread
MAX_TILES_PER_CHUNK = 16
MIN_PROGRAMS = 1056     # 8 programs per SM on a 132-SM H100


def require_gpu(interpret: bool = False) -> None:
    """The kernel is compiled for NVIDIA GPUs only; interpret mode (the
    CPU tests) is the one exception, and it has to be asked for."""
    if interpret:
        return
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise RuntimeError(
            f"the correlator kernel runs on NVIDIA GPUs; this process "
            f"runs on {platform!r}.  Use the XLA epoch "
            f"(use_pallas=False) or interpret mode.")


def geometry(blk: int, n_rows: int):
    """Static launch geometry for a bank of ``n_rows`` channel rows whose
    windows hold ``blk`` samples.

    Returns (tiles_per_chunk, n_chunks, span): the grid is
    (n_rows, n_chunks) and each program covers tiles_per_chunk tiles, so
    the kernel reads up to ``span`` = n_chunks * tiles_per_chunk * TILE
    samples past each window offset (masked beyond ``blk``).  Chunks
    grow only while the grid keeps at least MIN_PROGRAMS programs."""
    n_tiles = -(-blk // TILE)
    tpc = 1
    while (tpc * 2 <= min(MAX_TILES_PER_CHUNK, n_tiles)
           and n_rows * -(-n_tiles // (tpc * 2)) >= MIN_PROGRAMS):
        tpc *= 2
    n_chunks = -(-n_tiles // tpc)
    return tpc, n_chunks, n_chunks * tpc * TILE


def _taps(tab, row, start, mask, alpha, k, interp):
    """E/P/L replica tiles of one table row (an index tuple) from flat
    table offset ``start`` on."""
    def load(o):
        return plgpu.load(tab.at[row + (pl.ds(o, TILE),)], mask=mask,
                          other=0).astype(jnp.float32)

    out = []
    for d in (0, k, 2 * k):
        a = load(start + d)
        if interp:
            a = a + alpha * (load(start + d + 1) - a)
        out.append(a)
    return out


@functools.lru_cache(maxsize=64)
def _build_call(n_rows: int, n_tab: int, blk: int, k: int, n_pilot: int,
                interp: bool, interpret: bool):
    tpc, n_chunks, _ = geometry(blk, n_rows)
    n_out = 6 * (1 + n_pilot)

    def kernel(off_r, ts_r, ps_r, alpha_r, palpha_r, bsz_r, ur_r, ui_r,
               vr_r, vi_r, si_r, sq_r, ct_r, *rest):
        pt_r = rest[0] if n_pilot else None
        out_r = rest[-1]
        r = pl.program_id(0)
        j = pl.program_id(1)
        tr = jax.lax.rem(r, jnp.int32(n_tab))     # flat banks share tables
        off = off_r[r]
        ts = ts_r[r].astype(jnp.int32)
        ps = ps_r[r].astype(jnp.int32)
        alpha = alpha_r[r]
        palpha = palpha_r[r]
        bsz = bsz_r[r].astype(jnp.int32)
        lanes = jax.lax.broadcasted_iota(jnp.int32, (TILE,), 0)
        vr = vr_r[r, :]
        vi = vi_r[r, :]

        def body(t, acc):
            g = j * tpc + t                       # tile index in window
            base = g * TILE
            mask = base + lanes < bsz
            si = plgpu.load(si_r.at[pl.ds(off + base, TILE)],
                            mask=mask, other=0).astype(jnp.float32)
            sq = plgpu.load(sq_r.at[pl.ds(off + base, TILE)],
                            mask=mask, other=0).astype(jnp.float32)
            ur = ur_r[r, g]
            ui = ui_r[r, g]
            cw = ur * vr - ui * vi
            sw = ur * vi + ui * vr
            # e^{-j phase} · (I + jQ)
            bi = si * cw + sq * sw
            bq = sq * cw - si * sw
            reps = _taps(ct_r, (tr,), ts + base, mask, alpha, k, interp)
            if n_pilot == 1:
                reps += _taps(pt_r, (tr,), ps + base, mask, palpha, k,
                              interp)
            for b in range(n_pilot if n_pilot == 2 else 0):
                reps += _taps(pt_r, (tr, b), ps + base, mask, palpha, k,
                              interp)
            new = []
            for i, rep in enumerate(reps):
                new.append(acc[2 * i] + rep * bi)
                new.append(acc[2 * i + 1] + rep * bq)
            return tuple(new)

        zero = jnp.zeros((TILE,), jnp.float32)
        acc = jax.lax.fori_loop(0, tpc, body, (zero,) * n_out)
        for i in range(n_out):
            out_r[i, r, j] = jnp.sum(acc[i])

    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((n_out, n_rows, n_chunks),
                                       jnp.float32),
        grid=(n_rows, n_chunks),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=2),
        interpret=interpret,
        name="epoch_correlator",
    )


def correlate_bank(sig_i, sig_q, code_tables, pilot_tables, off, tstart,
                   pstart, alpha, palpha, bsz, carr_cycles, carr_step,
                   *, blk: int, k: int, n_pilot: int = 0,
                   interp_taps: bool = True, interpret: bool = False):
    """Raw correlator sums of one epoch for a bank of channel rows.

    sig_i/sig_q: [N + span] int8 (or int16) sample planes, zero-padded
      at the end by ``span = geometry(blk, C)[2]`` so that every tile
      read stays inside the arrays
    code_tables: [R, L + pad] int8 replica tables; row c uses table row
      c mod R (the flat time-parallel bank shares each channel's table
      across its time blocks)
    pilot_tables: [R, L + pad] (n_pilot=1) or [R, 2, L + pad] (n_pilot=2)
    off: [C] int window offset into the planes (clamped by the caller to
      [0, N - blk]); tstart/pstart: [C] int table window offsets of the
      early tap (clamped to [0, L - blk - 2k - 1])
    alpha/palpha: [C] f32 replica interpolation fractions
    bsz: [C] valid samples in the window (<= blk)
    carr_cycles/carr_step: [C] f64 carrier phase at the window start and
      phase step per sample, both in cycles
    Returns [C, 6 * (1 + n_pilot)] f32:
      iE qE iP qP iL qL [ piE pqE piP pqP piL pqL [ p2iE ... p2qL ] ]
    with the pilot sums taken against the unrotated baseband.
    """
    require_gpu(interpret)
    n_rows = off.shape[0]
    tpc, n_chunks, span = geometry(blk, n_rows)
    n_tiles = n_chunks * tpc
    # carrier factors from float64 phases: u per tile, v per lane
    t0 = (jnp.arange(n_tiles, dtype=jnp.float64) * TILE)[None, :]
    pu = carr_cycles[:, None] + carr_step[:, None] * t0
    pu = (2.0 * jnp.pi * (pu - jnp.round(pu))).astype(jnp.float32)
    lane = jnp.arange(TILE, dtype=jnp.float64)[None, :]
    pv = carr_step[:, None] * lane
    pv = (2.0 * jnp.pi * (pv - jnp.round(pv))).astype(jnp.float32)
    idx = jnp.int64 if sig_i.shape[0] >= 2 ** 31 else jnp.int32
    args = [off.astype(idx), tstart.astype(jnp.int32),
            pstart.astype(jnp.int32), alpha.astype(jnp.float32),
            palpha.astype(jnp.float32), bsz.astype(jnp.int32),
            jnp.cos(pu), jnp.sin(pu), jnp.cos(pv), jnp.sin(pv),
            sig_i, sig_q, code_tables]
    if n_pilot:
        args.append(pilot_tables)
    call = _build_call(n_rows, code_tables.shape[0], int(blk), int(k),
                       int(n_pilot), bool(interp_taps), bool(interpret))
    partial = call(*args)                    # [n_out, C, n_chunks]
    return jnp.sum(partial, axis=2).T
