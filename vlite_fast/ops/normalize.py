"""Detection, running-bandpass normalization, pol/time scrunching.

A JAX reimplementation of detect_and_normalize2/3, pscrunch[_weights]
and tscrunch[_weights] (ref src/pb_kernels.cu:393-630).

The bandpass is an exponential moving average updated once per spectrum
(97.66 us) with weight bp_scale = tsamp/tsmooth ~ 7.8e-4 (ref
src/process_baseband.cu:737-741).  The CUDA code walks time serially per
channel-thread; here the serial dimension is a lax.scan carrying the
(npol, nchan) bandpass, so the per-step body is a fully-vectorized
(npol, nchan) elementwise op on the VPU.  The weighted variant
(detect_and_normalize3) has a data-dependent clip that makes the recurrence
nonlinear, so scan is the honest implementation for both.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from vlite_fast import constants as C


class NormState(NamedTuple):
    bp: jax.Array  # (npol, nchan) running bandpass; 0 = uninitialized


def detect(fft_out: jax.Array) -> jax.Array:
    """|X|^2 detection. fft_out: complex (npol, ntime, nchan) -> float32."""
    return (jnp.real(fft_out) ** 2 + jnp.imag(fft_out) ** 2).astype(jnp.float32)


@partial(jax.jit, static_argnames=())
def normalize_ema(power: jax.Array, bp: jax.Array,
                  scale: float) -> tuple[jax.Array, jax.Array]:
    """Unweighted bandpass normalization (detect_and_normalize2,
    ref src/pb_kernels.cu:393-429).

    power: (npol, ntime, nchan); bp: (npol, nchan) carry (0 = seed from the
    mean of this chunk).  Returns (out, new_bp) with out = p/bp - 1.
    A fully gap-filled (all-zero) chunk would seed bp=0 and emit NaN
    (0/0) — the zero-power seed falls back to 1 instead.
    """
    seed = jnp.mean(power, axis=1)
    seed = jnp.where(seed == 0.0, 1.0, seed)
    bp0 = jnp.where(bp == 0.0, seed, bp)

    def step(bp_c, p_t):
        bp_n = scale * p_t + (1.0 - scale) * bp_c
        return bp_n, p_t / bp_n - 1.0

    bp_f, out = jax.lax.scan(step, bp0, jnp.swapaxes(power, 0, 1), unroll=8)
    return jnp.swapaxes(out, 0, 1), bp_f


@partial(jax.jit, static_argnames=())
def normalize_ema_weighted(power: jax.Array, weights: jax.Array,
                           bp: jax.Array, scale: float,
                           clip_ratio: float = C.BP_CLIP_RATIO,
                           clip_value: float = C.BP_CLIP_VALUE,
                           ) -> tuple[jax.Array, jax.Array]:
    """Kurtosis-weighted normalization (detect_and_normalize3,
    ref src/pb_kernels.cu:431-511).

    power: (npol, ntime, nchan); weights: (npol, ntime) surviving fraction
    per spectrum; bp: (npol, nchan).
    Semantics per (pol, t, chan):
      w == 0          -> out = 0, no bandpass update
      p/w > clip*bp   -> out = clip_value, no bandpass update
      else            -> bp = s*(p/w) + (1-s)*bp ; out = (p/w)/bp - 1
    Seeding (bp==0): mean over good samples of p/w, or 1 if none good.
    """
    w3 = weights[:, :, None]
    good = w3 > 0.0
    pw = jnp.where(good, power / jnp.where(good, w3, 1.0), 0.0)
    ngood = jnp.sum(good, axis=1)
    seed = jnp.where(ngood > 0,
                     jnp.sum(pw, axis=1) / jnp.maximum(ngood, 1),
                     1.0)
    bp0 = jnp.where(bp == 0.0, seed, bp)
    # stale-bandpass recovery (deliberate divergence from the reference,
    # whose carried bandpass can wedge after a data gap — saturating the
    # output through the clip path for seconds, the acknowledged TODO at
    # pb_kernels.cu:488-494): if this chunk's mean power is more than 5x
    # off the carried bandpass in either direction, the carry is stale —
    # re-seed from the chunk mean.  Real signals perturb a 100 ms chunk
    # mean by <<5x, so normal operation is untouched.
    stale = (ngood > 0) & ((seed > 5.0 * bp0) | (seed < 0.2 * bp0))
    bp0 = jnp.where(stale, seed, bp0)

    def step(bp_c, inp):
        p_t, good_t = inp          # (npol, nchan), (npol, 1->nchan bool)
        clipped = p_t > bp_c * clip_ratio
        update = good_t & (~clipped)
        bp_n = jnp.where(update, scale * p_t + (1.0 - scale) * bp_c, bp_c)
        out = jnp.where(good_t,
                        jnp.where(clipped, clip_value, p_t / bp_n - 1.0),
                        0.0)
        return bp_n, out

    bp_f, out = jax.lax.scan(
        step, bp0,
        (jnp.swapaxes(pw, 0, 1), jnp.swapaxes(good, 0, 1)),
        unroll=8)
    return jnp.swapaxes(out, 0, 1), bp_f


def _affine_scan(a: jax.Array, b: jax.Array, bp0: jax.Array) -> jax.Array:
    """All states of the recurrence bp_t = a_t*bp_{t-1} + b_t, computed in
    log depth with an associative scan (time axis 0).

    The composition of two affine updates is affine:
    (a1,b1) then (a2,b2) == (a1*a2, a2*b1 + b2) — so the EMA's 10240
    sequential steps per second become ~14 fully-vectorized passes, which
    is what makes the bandpass tracker data-parallel instead of a serial loop
    (the CUDA reference walks time serially per channel-thread,
    pb_kernels.cu:413-428).
    """
    def combine(x, y):
        a1, b1 = x
        a2, b2 = y
        return a1 * a2, a2 * b1 + b2

    aa, bb = jax.lax.associative_scan(combine, (a, b), axis=0)
    return aa * bp0[None] + bb


def _affine_scan_matmul(a: jax.Array, b: jax.Array,
                        bp0: jax.Array) -> jax.Array:
    """All states of bp_t = a_t*bp_{t-1} + b_t as TWO small matmuls
    (arrays are (npol, T, nchan); recurrence runs along the middle axis;
    a_t > 0).

    Closed form of the recurrence: with P_t = prod_{j<=t} a_j,
    bp_t = P_t * (bp0 + sum_{j<=t} b_j / P_j).  Both prefix reductions
    are one (T, T) lower-triangular matmul each (cumprod via
    exp(L @ log a)) — this replaces lax.associative_scan's log-depth
    tree of pad/slice ops (~240 tiny data-movement ops per segment) with
    matmuls that XLA fuses cleanly.  Conditioning: the chain's
    a_t is 1 or (1-bp_scale) with bp_scale ~ 7.8e-4 over T <= 32 steps,
    so P_t is in [0.975, 1] and the division is benign.

    Layout: arrays stay (npol, T, nchan) end to end — the prefix
    reductions contract the MIDDLE axis via einsum('tj,pjc->ptc'), so no
    transpose/copy of the 1.6 MB power blocks is ever materialized.
    """
    shape = jnp.broadcast_shapes(a.shape, b.shape)   # (npol, T, nchan)
    a = jnp.broadcast_to(a, shape)
    b = jnp.broadcast_to(b, shape)
    T = shape[1]
    L = jnp.tril(jnp.ones((T, T), jnp.float32))
    hp = jax.lax.Precision.HIGHEST
    P = jnp.exp(jnp.einsum("tj,pjc->ptc", L, jnp.log(a), precision=hp))
    S = jnp.einsum("tj,pjc->ptc", L, b / P, precision=hp)
    return P * (bp0[:, None, :] + S)


@partial(jax.jit, static_argnames=())
def normalize_ema_matmul(power: jax.Array, bp: jax.Array,
                         scale: float) -> tuple[jax.Array, jax.Array]:
    """normalize_ema computed via the matmul affine scan (identical math
    to normalize_ema_assoc up to f32 rounding; see _affine_scan_matmul
    for why this form)."""
    seed = jnp.mean(power, axis=1)
    seed = jnp.where(seed == 0.0, 1.0, seed)
    bp0 = jnp.where(bp == 0.0, seed, bp)
    T = power.shape[1]
    # constant a = (1-scale): P_t = (1-scale)^(t+1) is a trace-time
    # constant, so only the prefix SUM needs a matmul; layout stays
    # (npol, T, nchan) throughout (see _affine_scan_matmul)
    hp = jax.lax.Precision.HIGHEST
    L = jnp.tril(jnp.ones((T, T), jnp.float32))
    P = jnp.power(jnp.float32(1.0 - scale),
                  jnp.arange(1, T + 1, dtype=jnp.float32))[None, :, None]
    S = jnp.einsum("tj,pjc->ptc", L, (scale * power) / P, precision=hp)
    bp_t = P * (bp0[:, None, :] + S)
    out = power / bp_t - 1.0
    return out, bp_t[:, -1]


@partial(jax.jit, static_argnames=("refine",))
def normalize_ema_weighted_matmul(power: jax.Array, weights: jax.Array,
                                  bp: jax.Array, scale: float,
                                  clip_ratio: float = C.BP_CLIP_RATIO,
                                  clip_value: float = C.BP_CLIP_VALUE,
                                  refine: int = 0
                                  ) -> tuple[jax.Array, jax.Array]:
    """normalize_ema_weighted_assoc with the matmul affine-scan solver
    (same fixed-point treatment of the clip nonlinearity)."""
    w3 = weights[:, :, None]
    good = w3 > 0.0
    pw = jnp.where(good, power / jnp.where(good, w3, 1.0), 0.0)
    ngood = jnp.sum(good, axis=1)
    seed = jnp.where(ngood > 0,
                     jnp.sum(pw, axis=1) / jnp.maximum(ngood, 1), 1.0)
    bp0 = jnp.where(bp == 0.0, seed, bp)
    # stale-bandpass recovery — see normalize_ema_weighted
    stale = (ngood > 0) & ((seed > 5.0 * bp0) | (seed < 0.2 * bp0))
    bp0 = jnp.where(stale, seed, bp0)

    # layout stays (npol, T, nchan) throughout (see _affine_scan_matmul)
    def solve(update_mask):
        a = jnp.where(update_mask, 1.0 - scale, 1.0)
        b = jnp.where(update_mask, scale * pw, 0.0)
        return _affine_scan_matmul(a, b, bp0)

    def decide(bp_t):
        bp_prev = jnp.concatenate([bp0[:, None, :], bp_t[:, :-1]], axis=1)
        return good & (pw <= clip_ratio * bp_prev)

    bp_t = solve(good)              # pass ignoring clips
    update = decide(bp_t)
    bp_t = solve(update)
    for _ in range(refine):
        update = decide(bp_t)
        bp_t = solve(update)
    clipped = good & (~update)
    out = jnp.where(good,
                    jnp.where(clipped, clip_value, pw / bp_t - 1.0), 0.0)
    return out, bp_t[:, -1]


@partial(jax.jit, static_argnames=())
def normalize_ema_assoc(power: jax.Array, bp: jax.Array,
                        scale: float) -> tuple[jax.Array, jax.Array]:
    """Log-depth equivalent of normalize_ema (identical math, different
    summation order; agreement to f32 rounding)."""
    seed = jnp.mean(power, axis=1)
    seed = jnp.where(seed == 0.0, 1.0, seed)
    bp0 = jnp.where(bp == 0.0, seed, bp)
    p = jnp.swapaxes(power, 0, 1)                      # (T, npol, nchan)
    a = jnp.full_like(p, 1.0 - scale)
    bp_t = _affine_scan(a, scale * p, bp0)
    out = p / bp_t - 1.0
    return jnp.swapaxes(out, 0, 1), bp_t[-1]


@partial(jax.jit, static_argnames=("refine",))
def normalize_ema_weighted_assoc(power: jax.Array, weights: jax.Array,
                                 bp: jax.Array, scale: float,
                                 clip_ratio: float = C.BP_CLIP_RATIO,
                                 clip_value: float = C.BP_CLIP_VALUE,
                                 refine: int = 0
                                 ) -> tuple[jax.Array, jax.Array]:
    """Log-depth detect_and_normalize3.

    The clip decision (p > clip_ratio * running bp) makes the recurrence
    nonlinear, so this solves it by fixed-point iteration: compute the
    bandpass ignoring clips, decide the clip mask against it, then redo the
    (now linear, mask-conditioned) recurrence exactly; `refine` extra
    rounds re-decide against the updated bandpass.  Clips fire less than
    ~once per 1.5 s by design (ref pb_kernels.cu:483-494), so one round
    almost always reaches the sequential fixed point.
    """
    w3 = weights[:, :, None]
    good = w3 > 0.0
    pw = jnp.where(good, power / jnp.where(good, w3, 1.0), 0.0)
    ngood = jnp.sum(good, axis=1)
    seed = jnp.where(ngood > 0,
                     jnp.sum(pw, axis=1) / jnp.maximum(ngood, 1), 1.0)
    bp0 = jnp.where(bp == 0.0, seed, bp)
    # stale-bandpass recovery (deliberate divergence from the reference,
    # whose carried bandpass can wedge after a data gap — saturating the
    # output through the clip path for seconds, the acknowledged TODO at
    # pb_kernels.cu:488-494): if this chunk's mean power is more than 5x
    # off the carried bandpass in either direction, the carry is stale —
    # re-seed from the chunk mean.  Real signals perturb a 100 ms chunk
    # mean by <<5x, so normal operation is untouched.
    stale = (ngood > 0) & ((seed > 5.0 * bp0) | (seed < 0.2 * bp0))
    bp0 = jnp.where(stale, seed, bp0)

    p = jnp.swapaxes(pw, 0, 1)                         # (T, npol, nchan)
    g = jnp.swapaxes(good, 0, 1)

    def solve(update_mask):
        a = jnp.where(update_mask, 1.0 - scale, 1.0)
        b = jnp.where(update_mask, scale * p, 0.0)
        return _affine_scan(a, b, bp0)

    def decide(bp_t):
        bp_prev = jnp.concatenate([bp0[None], bp_t[:-1]], axis=0)
        return g & (p <= clip_ratio * bp_prev)

    bp_t = solve(g)                 # pass ignoring clips
    update = decide(bp_t)
    bp_t = solve(update)
    for _ in range(refine):
        update = decide(bp_t)
        bp_t = solve(update)
    clipped = g & (~update)
    out = jnp.where(g, jnp.where(clipped, clip_value, p / bp_t - 1.0), 0.0)
    return jnp.swapaxes(out, 0, 1), bp_t[-1]


def pscrunch(x: jax.Array) -> jax.Array:
    """Sum polarizations, variance-normalized (ref src/pb_kernels.cu:514-524).

    x: (2, ntime, nchan) -> (1, ntime, nchan)."""
    return (jnp.float32(jnp.sqrt(0.5)) * (x[0] + x[1]))[None]


def pscrunch_weights(x: jax.Array, weights: jax.Array,
                     min_weight: float = C.MIN_WEIGHT
                     ) -> tuple[jax.Array, jax.Array]:
    """Weighted pol sum (ref src/pb_kernels.cu:527-560).

    x: (2, ntime, nchan); weights: (2, ntime) -> ((1, ntime, nchan),
    (1, ntime)).
    Both pols good: (x0+x1)/sqrt(2), w = (w0+w1)/2.  One good: that pol,
    w = its weight.  None: 0, 0.
    """
    w0, w1 = weights[0], weights[1]
    g0 = (w0 >= min_weight)
    g1 = (w1 >= min_weight)
    both = (g0 & g1)[:, None]
    xg = (x[0] * g0[:, None].astype(x.dtype)
          + x[1] * g1[:, None].astype(x.dtype))
    out = jnp.where(both, jnp.float32(jnp.sqrt(0.5)) * (x[0] + x[1]), xg)
    w_out = jnp.where(g0 & g1, 0.5 * (w0 + w1), w0 * g0 + w1 * g1)
    return out[None], w_out[None]


def tscrunch(x: jax.Array, nscrunch: int) -> jax.Array:
    """Time average (ref src/pb_kernels.cu:562-589): sum of nscrunch samples
    scaled by 1/sqrt(nscrunch).  x: (npol, ntime, nchan)."""
    npol, ntime, nchan = x.shape
    y = x.reshape(npol, ntime // nscrunch, nscrunch, nchan)
    return jnp.sum(y, axis=2) * jnp.float32(1.0 / jnp.sqrt(nscrunch))


def tscrunch_weights(x: jax.Array, weights: jax.Array, nscrunch: int,
                     min_weight: float = C.MIN_WEIGHT) -> jax.Array:
    """Weighted time average (ref src/pb_kernels.cu:591-630).

    x: (npol, ntime, nchan); weights: (npol, ntime).
    out = sum(w_t * x_t over good t) / sqrt(#good) if mean good weight >=
    min_weight else 0.
    """
    npol, ntime, nchan = x.shape
    w = weights.reshape(npol, ntime // nscrunch, nscrunch)
    good = (w >= min_weight)
    wg = jnp.where(good, w, 0.0)
    cnt = jnp.sum(good, axis=-1)
    wsumf = jnp.sum(wg, axis=-1)
    y = x.reshape(npol, ntime // nscrunch, nscrunch, nchan)
    acc = jnp.sum(wg[..., None] * y, axis=2)
    ok = (wsumf / nscrunch) >= min_weight
    denom = jnp.sqrt(jnp.maximum(cnt, 1).astype(x.dtype))
    return jnp.where(ok[..., None], acc / denom[..., None], 0.0)
