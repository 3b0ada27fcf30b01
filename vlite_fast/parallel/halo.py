"""Overlap-save halo exchange between time-shard neighbors.

This is the system's sequence parallelism (SURVEY.md section 5): operations
whose receptive field is the DM smearing time (incoherent dedispersion over a
gulp, coherent chirp convolution) need `halo` samples of lookahead beyond a
shard's own time block.  On the mesh this is a ppermute from the next
neighbor, the collective equivalent of genbase's overlap copy
(ref src/genbase.cu:371-390) and heimdall's gulp overlap.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def halo_from_next(x: jax.Array, halo: int, axis_name: str) -> jax.Array:
    """Inside shard_map: append the first `halo` rows of the *next* time
    shard to this shard's block (axis 0 = time).

    The last shard (no successor) receives zeros, matching the zero-padded
    tail of a finite observation.
    """
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    head = jax.lax.slice_in_dim(x, 0, halo, axis=0)
    # shard i receives shard (i+1)'s head: permutation (src=i+1 -> dst=i)
    perm = [((i + 1) % n, i) for i in range(n)]
    recv = jax.lax.ppermute(head, axis_name, perm)
    recv = jnp.where(idx == n - 1, jnp.zeros_like(recv), recv)
    return jnp.concatenate([x, recv], axis=0)


def halo_from_prev(x: jax.Array, halo: int, axis_name: str) -> jax.Array:
    """Prepend the last `halo` rows of the *previous* time shard (for
    operations with backward-looking context, e.g. coherent dedispersion
    whose smearing extends earlier in time)."""
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    tail = jax.lax.slice_in_dim(x, x.shape[0] - halo, x.shape[0], axis=0)
    perm = [(i, (i + 1) % n) for i in range(n)]
    recv = jax.lax.ppermute(tail, axis_name, perm)
    recv = jnp.where(idx == 0, jnp.zeros_like(recv), recv)
    return jnp.concatenate([recv, x], axis=0)
