"""Device-mesh scale-out for acquisition and tracking.

The reference is single-threaded MATLAB; its latent parallel axes (PRNs in
acquisition, channels in tracking — SURVEY.md §2.4) become mesh axes here:

  * channel-bank sharding (DP-analog): ChannelState/code tables sharded
    over the 'ch' axis; the sample superblock is replicated; tracking is
    embarrassingly parallel across channels, no collectives inside a
    superblock.
  * PRN sharding in acquisition (EP-analog): the per-PRN correlation work
    is vmapped and sharded over 'ch'; the mixed-signal FFT is replicated
    (it is shared by construction).

Time-block sequence parallelism (SP-analog, overlap-save halo exchange) is
the round-2 axis; the superblock orchestration in tracking/engine.py is
already written against block boundaries to support it.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..tracking.engine import ChannelState, TrackParams


def make_mesh(n_devices: Optional[int] = None, axis: str = "ch") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.asarray(devs[:n]), (axis,))


def shard_channel_bank(state: ChannelState, code_tables, pilot_tables,
                       mesh: Mesh):
    """Place per-channel arrays on the mesh, sharded over channels."""
    s1 = NamedSharding(mesh, P("ch"))
    state = jax.tree.map(lambda x: jax.device_put(x, s1), state)
    code_tables = jax.device_put(code_tables, NamedSharding(mesh,
                                                            P("ch", None)))
    pilot_tables = jax.device_put(pilot_tables,
                                  NamedSharding(mesh, P("ch", None)))
    return state, code_tables, pilot_tables


@functools.partial(jax.jit, static_argnames=("params", "n_epochs"))
def tracking_step_sharded(samples_iq, sb_start, code_tables, pilot_tables,
                          state: ChannelState, params: TrackParams,
                          n_epochs: int):
    """tracking.engine.track_superblock with the channel axis sharded by
    argument placement (GSPMD partitions the vmapped XLA epoch across
    the mesh; the GPU kernel's custom call is not partitioned, so GSPMD
    gathers its operands); delegates so both correlator paths stay in
    sync."""
    from ..tracking.engine import track_superblock
    return track_superblock(samples_iq, sb_start, code_tables,
                            pilot_tables, state, params, n_epochs)


@functools.partial(jax.jit, static_argnames=("n_comp", "search_len"))
def pcps_sharded(slabs, code_fft_conj, weights, f_grid, ts, n_comp: int,
                 search_len: int = None):
    """PRN-parallel PCPS: vmap over the (sharded) PRN axis instead of the
    sequential scan used single-chip (acquisition/pcps.py).

    slabs and code_fft_conj are (real, imag) float32 pairs;
    code_fft_conj pair arrays [n_prn, n_comp, nfft] sharded over axis 0;
    slabs replicated.  Returns (peak, bin, phase, second, floor) each [n_prn].
    """
    from ..acquisition.pcps import _corr_peak, _mixed_fft
    mf = _mixed_fft(slabs[0], slabs[1], f_grid, ts)

    def one_prn(cfr, cfi):
        return _corr_peak(mf, (cfr, cfi), weights, n_comp,
                          search_len)

    return jax.vmap(one_prn)(code_fft_conj[0], code_fft_conj[1])
