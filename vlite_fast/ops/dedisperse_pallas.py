"""Two-stage shift-and-sum dedispersion as a Pallas kernel for the GPU
(Triton route) — the heimdall/dedisp role (ref
scripts/start_heimdall_single_antenna:21; dedisp's subband kernel).

The same subband decomposition as ops.dedisperse.dedisperse, with the
same add order, so interpret mode on the CPU is bit-exact to it:

* stage 1: y[b, s, t] = sum over the w channels ch of subband s, in
  order, of fb[ch, t + rel[b, ch]].  Grid (DM batch, time tile,
  subband) with the batch fastest, so the programs in flight share one
  subband's slab of the filterbank (w * tile samples, served from L2).
* stage 2: out[dm, t] = sum over subbands s, in order, of
  y[batch(dm), s, t + sub[dm, s]].  Grid (DM, time tile) with the DM
  fastest: the DMs of one batch sit next to each other, so their common
  y[batch] stays in L2.

Each program reads its own delays, accumulates one time tile in
registers and writes it once; nothing is carried between programs.
Every read is in range by construction: the wrapper pads the
channel-major filterbank by repeating its last sample (the index clip of
ops.dedisperse.dedisperse) and sizes the stage-1 plane for every stage-2
read, so the kernels need no masks.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from vlite_fast.ops.dedisperse import DedispPlan

# Launch parameters, chosen once on the card at the production gulp
# (the launch sweep in PERF.md's PR 1 findings; benchmarks/bench_search.py
# --sweep reruns it): powers of two as Triton requires.
TILE = 512
NUM_WARPS = 8
NUM_STAGES = 3


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _stage1_kernel(rel_ref, fb_ref, y_ref, *, w: int, tile: int):
    b, k, s = pl.program_id(0), pl.program_id(1), pl.program_id(2)
    t0 = k * tile

    def body(c, acc):
        ch = s * w + c
        d = rel_ref[b, ch]
        return acc + fb_ref[ch, pl.ds(t0 + d, tile)]

    acc = jax.lax.fori_loop(0, w, body, jnp.zeros((tile,), jnp.float32))
    y_ref[b, s, pl.ds(t0, tile)] = acc


def _stage2_kernel(sub_ref, bod_ref, y_ref, out_ref, *, nsub: int,
                   tile: int):
    dm, k = pl.program_id(0), pl.program_id(1)
    t0 = k * tile
    b = bod_ref[dm]

    def body(s, acc):
        d = sub_ref[dm, s]
        return acc + y_ref[b, s, pl.ds(t0 + d, tile)]

    acc = jax.lax.fori_loop(0, nsub, body,
                            jnp.zeros((tile,), jnp.float32))
    out_ref[dm, pl.ds(t0, tile)] = acc


@functools.partial(jax.jit, static_argnames=(
    "ntime_out", "tile", "num_warps", "num_stages", "interpret"))
def dedisperse_pallas(fb: jax.Array, plan: DedispPlan, ntime_out: int,
                      tile: int = TILE, num_warps: int = NUM_WARPS,
                      num_stages: int = NUM_STAGES,
                      interpret: bool = False) -> jax.Array:
    """fb: (ntime, nchan) float32, ntime >= ntime_out + plan.max_delay.
    Returns the (ndm, ntime_out) float32 DM-time plane (channel-summed,
    zapped channels excluded), bit-exact to ops.dedisperse.dedisperse.

    interpret=True runs the kernels in the Pallas interpreter (CPU
    tests); otherwise they compile for the GPU through Triton.
    """
    if tile & (tile - 1):
        raise ValueError(f"tile must be a power of two, got {tile}")
    ntime, nchan = fb.shape
    nsub = plan.nsub
    w = nchan // nsub
    nbatch = plan.rel_delays.shape[0]
    ndm = plan.sub_delays.shape[0]

    nt2 = _cdiv(ntime_out, tile)                   # stage-2 time tiles
    nt1 = _cdiv(nt2 * tile + plan.max_sub_delay, tile)
    t1_pad = nt1 * tile                            # stage-1 plane length
    fin_len = t1_pad + plan.rel_delays_max         # furthest stage-1 read

    fbt = (fb * plan.chan_weights[None, :]).T      # channel-major
    if fin_len > ntime:
        fbt = jnp.pad(fbt, ((0, 0), (0, fin_len - ntime)), mode="edge")

    params = plgpu.CompilerParams(num_warps=num_warps,
                                  num_stages=num_stages)
    y = pl.pallas_call(
        functools.partial(_stage1_kernel, w=w, tile=tile),
        out_shape=jax.ShapeDtypeStruct((nbatch, nsub, t1_pad),
                                       jnp.float32),
        grid=(nbatch, nt1, nsub),
        compiler_params=params,
        interpret=interpret,
        name="dedisp_stage1",
    )(plan.rel_delays.astype(jnp.int32), fbt)

    out = pl.pallas_call(
        functools.partial(_stage2_kernel, nsub=nsub, tile=tile),
        out_shape=jax.ShapeDtypeStruct((ndm, nt2 * tile), jnp.float32),
        grid=(ndm, nt2),
        compiler_params=params,
        interpret=interpret,
        name="dedisp_stage2",
    )(plan.sub_delays.astype(jnp.int32),
      plan.batch_of_dm.astype(jnp.int32), y)
    return out[:, :ntime_out]
