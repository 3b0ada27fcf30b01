"""Device-mesh construction for the (ant, time) decomposition.

The reference scales by pure antenna data-parallelism across 12 hosts plus an
MPI reduce for the coadd (SURVEY.md section 2d).  This design maps (the mesh
follows the algorithm; every card of a host reaches every other over
NVLink at the same rate):

  'ant'  — antennas sharded over chips; the cross-antenna coadd is a psum
           over this axis (replaces agdadacoadd's MPI reduce over hostfiles).
  'time' — time-blocks of the search/offline stages sharded over chips with
           overlap-save halos exchanged between neighbors (replaces the
           reference's gulp overlap inside heimdall).

The streaming DSP itself is sequential per antenna (EMA bandpass carry), so
'time' parallelism applies to the search and offline stages, not the
per-second DSP recurrence.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_ant: int = 0, n_time: int = 0,
              devices: list | None = None) -> Mesh:
    """Build an (ant, time) mesh.  With no arguments, uses all devices on
    the 'ant' axis (the dominant parallelism at array scale)."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if n_ant == 0 and n_time == 0:
        n_ant, n_time = n, 1
    elif n_ant == 0:
        n_ant = n // n_time
    elif n_time == 0:
        n_time = n // n_ant
    if n_ant * n_time > n:
        raise ValueError(f"mesh {n_ant}x{n_time} > {n} devices")
    dev = np.asarray(devices[:n_ant * n_time]).reshape(n_ant, n_time)
    return Mesh(dev, axis_names=("ant", "time"))


def ant_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P("ant"))


def ant_time_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P("ant", "time"))
