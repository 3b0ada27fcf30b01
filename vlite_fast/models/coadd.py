"""Multi-antenna incoherent coadd (the agdadacoadd role).

The reference sums per-antenna filterbank streams with an MPI reduce onto a
root node's ring (ref scripts/start_coadd:19-57, SURVEY.md section 2a #18).
Here the coadd is a mesh collective: antennas live on a named mesh axis and
the coadd is a psum over it (parallel/sharded_pipeline.py); this module holds
the math + a single-host reference implementation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def coadd(fb_stack: jax.Array, weights: jax.Array | None = None) -> jax.Array:
    """(nant, ntime, nchan) normalized filterbanks -> (ntime, nchan).

    Sum scaled by 1/sqrt(nant) so unit-variance inputs stay unit-variance
    (S/N of a common signal grows as sqrt(nant), matching an incoherent
    array coadd)."""
    nant = fb_stack.shape[0]
    if weights is None:
        return jnp.sum(fb_stack, axis=0) * jnp.float32(1.0 / jnp.sqrt(nant))
    w = weights.reshape(nant, 1, 1).astype(fb_stack.dtype)
    wsum = jnp.sum(w ** 2)
    return jnp.sum(fb_stack * w, axis=0) * jax.lax.rsqrt(
        jnp.maximum(wsum, 1e-12))


def coadd_psum(fb_local: jax.Array, axis_name: str,
               nant_total: int) -> jax.Array:
    """Inside shard_map/pjit: sum this shard's antennas then all-reduce over
    the mesh 'ant' axis (a collective replacing the reference's MPI)."""
    local = jnp.sum(fb_local, axis=0)
    total = jax.lax.psum(local, axis_name)
    return total * jnp.float32(1.0 / jnp.sqrt(nant_total))
