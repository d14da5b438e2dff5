"""Multi-host distributed runtime (NVLink within a host, the network
between hosts).

The reference is a single MATLAB process (SURVEY.md §2.4); scale-out past
one host is new surface.  The model is JAX's standard multi-controller
SPMD: every host runs the same program, `jax.distributed.initialize`
joins them into one runtime, and `jax.devices()` becomes the GLOBAL
device list.  The mesh follows the algorithm: the cards of one host are
joined all to all by NVLink, so 'ch' and 'tb' may lie across them in any
order.  Across hosts, the channel axis ('ch') goes first — channel-bank
tracking needs no cross-channel collectives, so the only traffic between
hosts is the per-epoch PVT assembly — and the time-block axis ('tb')
stays within a host, where the ring state-handoff collective-permute of
parallel/timeblocks.py rides NVLink.

Data feeding follows the owner-computes pattern: each host constructs
only its addressable shards (jax.make_array_from_callback in
timeblocks._put), so IF sample blocks never cross the network.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_device_ids=None) -> None:
    """Join this process into the global JAX runtime.

    Arguments default to the CUSDR_COORDINATOR / CUSDR_NUM_PROCS /
    CUSDR_PROC_ID environment variables (or JAX's own cluster-detection
    when none are set; on a GPU host give all three explicitly, with a
    coordinator such as localhost:<port>).  Safe to call once per
    process, before any device arrays are created.
    """
    kw = {}
    addr = coordinator_address or os.environ.get("CUSDR_COORDINATOR")
    if addr:
        kw["coordinator_address"] = addr
    n = num_processes if num_processes is not None else \
        os.environ.get("CUSDR_NUM_PROCS")
    if n is not None:
        kw["num_processes"] = int(n)
    pid = process_id if process_id is not None else \
        os.environ.get("CUSDR_PROC_ID")
    if pid is not None:
        kw["process_id"] = int(pid)
    if local_device_ids is not None:
        kw["local_device_ids"] = local_device_ids
    jax.distributed.initialize(**kw)


def make_mesh_2d(n_ch: Optional[int] = None,
                 n_tb: Optional[int] = None) -> Mesh:
    """2-D (ch × tb) mesh over all GLOBAL devices.

    Default factorization: 'ch' spans processes (no collectives on the
    channel axis → no traffic between hosts), 'tb' the devices within a
    process (the ring handoff rides NVLink).  Works single-process too,
    where it falls back to n_ch = 1.
    """
    devs = np.asarray(jax.devices())
    if n_ch is None:
        n_ch = max(jax.process_count(), 1)
    if n_tb is None:
        n_tb = len(devs) // n_ch
    assert n_tb >= 1, \
        f"n_ch={n_ch} exceeds the {len(devs)} available devices " \
        f"(derived n_tb=0 would build an empty mesh)"
    assert n_ch * n_tb <= len(devs), \
        f"mesh {n_ch}x{n_tb} needs {n_ch * n_tb} devices, " \
        f"have {len(devs)}"
    return Mesh(devs[:n_ch * n_tb].reshape(n_ch, n_tb), ("ch", "tb"))
