"""Time-sharded coherent dedispersion with halo exchange.

The offline coherent-dedispersion step (ops/coherent.py) has a receptive
field of the DM smearing time: sample t of the output needs raw voltages
from [t - n_hi, t + n_lo].  On an (ant, time) mesh the voltage stream is
sharded over 'time', so each shard pulls n_hi trailing samples from its
previous neighbor and n_lo leading samples from its next neighbor
(ppermute), runs the chirp on the extended block, and keeps its own span —
the overlap-save pattern of genbase (ref src/genbase.cu:366-390) turned
into the mesh's sequence parallelism (SURVEY.md section 5).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from vlite_fast.ops import coherent as coh
from vlite_fast.parallel.halo import halo_from_next, halo_from_prev


def coherent_dedisperse_sharded(x: jax.Array, mesh: Mesh, dm: float,
                                sample_rate: float,
                                bandwidth_mhz: float = 64.0,
                                freq_bot_mhz: float = 320.0) -> jax.Array:
    """x: (npol, nsamp) sharded over 'time' on axis 1 -> dedispersed
    voltages with identical sharding.  Each shard's output matches the
    central (valid) region of an unsharded overlap-save block.
    """
    n_lo, n_hi = coh.smearing_samples(dm, sample_rate, freq_bot_mhz,
                                      freq_bot_mhz + bandwidth_mhz / 2,
                                      freq_bot_mhz + bandwidth_mhz)
    # full smearing span plus margin for the chirp's impulse-response
    # tails beyond the nominal group-delay support (measured ~5% error at
    # exact-halo block edges)
    halo = int((n_lo + n_hi) * 1.0 + 4096)
    npol, nsamp = x.shape
    ntime_shards = mesh.shape["time"]
    local = nsamp // ntime_shards
    if halo >= local:
        raise ValueError(f"shard span {local} smaller than the DM smearing "
                         f"halo {halo}; use fewer time shards")
    ext_len = local + 2 * halo

    def shard_fn(x_l):
        # x_l: (npol, local) — halo on the time axis (axis 0 for halo fns)
        xt = x_l.T                                   # (local, npol)
        xt = halo_from_prev(xt, halo, "time")        # past context
        xt = halo_from_next(xt, halo, "time")        # future context
        block = xt.T                                 # (npol, ext_len)
        ker = jnp.conj(coh.dispersion_kernel(ext_len, dm, bandwidth_mhz,
                                             freq_bot_mhz, taper=False))
        out = coh.apply_chirp(block, ker)
        return out[:, halo:halo + local]

    mapped = shard_map(
        shard_fn, mesh=mesh,
        in_specs=P(None, "time"), out_specs=P(None, "time"),
        check_vma=False)
    return mapped(x)
