"""Multi-host initialization and host-level sharding helpers.

The reference scales across 12 hosts by running independent process chains
plus MPI for the coadd (SURVEY.md section 2d).  The JAX equivalent is
multi-controller: every host runs the same program, jax.distributed wires
the hosts into one device mesh, data-plane collectives ride NVLink within a
host and the network between hosts, and
each host feeds only its local antennas (host-local data, globally-sharded
arrays).
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> dict:
    """Initialize jax.distributed from args or the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID).
    No-op on a single process.  Returns topology info."""
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator:
        num = int(num_processes
                  or os.environ.get("JAX_NUM_PROCESSES", "1"))
        pid = int(process_id or os.environ.get("JAX_PROCESS_ID", "0"))
        if num > 1:
            jax.distributed.initialize(coordinator_address=coordinator,
                                       num_processes=num, process_id=pid)
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }


def local_antenna_slice(nant: int) -> slice:
    """Which antennas this host captures/feeds: the contiguous block
    matching its position in the mesh (host-local data for a
    P('ant', ...) sharded array)."""
    per = -(-nant // jax.process_count())
    lo = jax.process_index() * per
    return slice(lo, min(lo + per, nant))


def make_global_array(local_np: np.ndarray, mesh, pspec) -> jax.Array:
    """Assemble a globally-sharded array from this host's local shard
    (jax.make_array_from_process_local_data): each host provides only its
    antennas' seconds; the result is addressable per-device."""
    from jax.sharding import NamedSharding
    sharding = NamedSharding(mesh, pspec)
    return jax.make_array_from_process_local_data(sharding, local_np)
