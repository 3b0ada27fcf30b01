"""Spectral-kurtosis RFI excision.

A JAX reimplementation of the kurtosis stack in the reference
(src/pb_kernels.cu): `kurtosis` (:35-107), `compute_dagostino` (:109-134),
`block_kurtosis` (:140-212), `compute_dagostino2` (:219-241) and
`apply_kurtosis` / `apply_kurtosis_fake` (:243-318).

Where the CUDA code uses shared-memory tree reductions per 500-sample window,
here windows become a reshaped axis and the reductions are plain jnp sums that
XLA vectorizes over the (pol, window) grid — there is no benefit to a Pallas
kernel for these (they fuse with the surrounding elementwise math).

Shapes: voltages are (npol, nsamp); fine-window stats are (npol, nwin) with
nwin = nsamp // nkurto; block stats are (npol, nblk) with
nblk = nsamp // nfft.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from vlite_fast import constants as C


class KurtosisResult(NamedTuple):
    """Everything the RFI stage produces for one chunk of voltages."""

    masked: jax.Array       # (npol, nsamp) voltages with bad windows zeroed
    weights: jax.Array      # (npol, nblk) surviving fraction per FFT block
    dag: jax.Array          # (nwin,) pol-combined fine-window TS
    dag_fb: jax.Array       # (nblk,) pol-combined block TS
    pow_w: jax.Array        # (npol, nwin) fine-window power
    kur_w: jax.Array        # (npol, nwin) fine-window kurtosis


def window_stats(x: jax.Array, nkurto: int) -> tuple[jax.Array, jax.Array]:
    """Power and kurtosis per nkurto-sample window.

    Ref: kurtosis kernel (src/pb_kernels.cu:35-107).
    x: (npol, nsamp) float32 -> (pow, kur) each (npol, nwin).
    """
    npol, nsamp = x.shape
    w = x.reshape(npol, nsamp // nkurto, nkurto)
    x2 = w * w
    m2 = jnp.mean(x2, axis=-1)
    m4 = jnp.mean(x2 * x2, axis=-1)
    # kur = m4 / m2^2; the reference divides unguarded (inf/nan for all-zero
    # windows, then mapped to DAG_INF by the zero test on kur)
    kur = m4 / jnp.where(m2 == 0, 1.0, m2 * m2)
    kur = jnp.where(m2 == 0, 0.0, kur)
    return m2, kur


def dagostino_ts(kur: jax.Array, n: int, dag_inf: float = C.DAG_INF) -> jax.Array:
    """D'Agostino K^2 kurtosis normality TS, pol-combined by max.

    Ref: compute_dagostino (src/pb_kernels.cu:109-134); constants follow
    pb_kernels.cu:3-20 via constants.dagostino_constants(n).
    kur: (npol, nwin) -> (nwin,) (the reference duplicates the pol-max into
    both pol slots; we return it once).
    """
    k = C.dagostino_constants(n)
    t = (1.0 - 2.0 / k["A"]) / (1.0 + (kur - 3.0 - k["mu1"]) * k["Z2_3"])
    dag = jnp.abs(k["Z2_1"] * (k["Z2_2"] - jnp.cbrt(t)))
    dag = jnp.where(t > 0, dag, dag_inf)
    dag = jnp.where(kur == 0.0, dag_inf, dag)
    return jnp.max(dag, axis=0)


def block_stats(pow_w: jax.Array, kur_w: jax.Array, dag: jax.Array,
                windows_per_fft: int,
                dag_thresh: float = C.DAG_THRESH) -> tuple[jax.Array, jax.Array]:
    """Filterbank-block power/kurtosis, zero-weighting already-flagged
    fine windows (the fine-time pre-filter).

    Ref: block_kurtosis (src/pb_kernels.cu:140-212).
    pow_w/kur_w: (npol, nwin); dag: (nwin,) pol-combined.
    Returns (pow_blk, kur_blk) each (npol, nblk).
    """
    npol, nwin = pow_w.shape
    nblk = nwin // windows_per_fft
    wt = (dag < dag_thresh).astype(pow_w.dtype)          # (nwin,)
    wt = jnp.broadcast_to(wt, (npol, nwin)).reshape(npol, nblk, windows_per_fft)
    p = pow_w.reshape(npol, nblk, windows_per_fft)
    q = kur_w.reshape(npol, nblk, windows_per_fft)
    wsum = jnp.sum(wt, axis=-1)
    psum = jnp.sum(wt * p, axis=-1)
    qsum = jnp.sum(wt * q * p * p, axis=-1)
    good = wsum > 0
    pblk = jnp.where(good, psum / jnp.where(good, wsum, 1.0), 0.0)
    kblk = jnp.where(good,
                     qsum / jnp.where(good, wsum, 1.0)
                     / jnp.where(good, pblk * pblk, 1.0),
                     0.0)
    return pblk, kblk


def apply_mask(x: jax.Array, dag: jax.Array, nkurto: int, nfft: int,
               dag_thresh: float = C.DAG_THRESH,
               fake: bool = False,
               debug_weights: bool = False,
               block_keep: jax.Array | None = None
               ) -> tuple[jax.Array, jax.Array]:
    """Zero voltages in flagged windows; per-FFT-block surviving weights.

    Ref: apply_kurtosis / apply_kurtosis_fake (src/pb_kernels.cu:243-318).
    Only the fine-window TS gates excision (the block TS is computed but its
    use is commented out in the reference, pb_kernels.cu:255-256).
    x: (npol, nsamp); dag: (nwin,) -> (masked (npol, nsamp),
    weights (npol, nblk)).

    block_keep: optional (nblk,) 0/1 gate (the dag_fb block-scale cut)
    folded into the same masking pass — a separate post-multiply would
    cost an extra full read+write of the voltage array.

    debug_weights reproduces the DEBUG_WEIGHTS deterministic mask
    (ref pb_kernels.cu:258-265): flag the second half of the chunk
    (as seen by pol 1's half of the flat buffer) and the [7/8, 1) span of
    the first pol's half — a known pattern for validating the weight
    bookkeeping through normalize/pscrunch/tscrunch.
    """
    npol, nsamp = x.shape
    nwin = nsamp // nkurto
    wpf = nfft // nkurto
    nblk = nwin // wpf
    if fake:
        good = jnp.ones((nwin,), dtype=x.dtype)
        return x, jnp.broadcast_to(
            jnp.mean(good.reshape(nblk, wpf), axis=-1), (npol, nblk))
    if debug_weights:
        # per-pol deterministic mask: the reference evaluates `bad` on the
        # flat dual-pol buffer [pol0 | pol1]: flat positions beyond
        # 1.5*nsamp (the second half of pol 1) and the final eighth of
        # pol 0 are zero-weighted
        pos = jnp.arange(nwin) * nkurto
        bad_p0 = pos > (7 * nsamp) // 8
        bad_p1 = pos > nsamp // 2
        good2 = jnp.stack([~bad_p0, ~bad_p1])[:npol]       # (npol, nwin)
    else:
        good2 = jnp.broadcast_to(dag < dag_thresh, (npol, nwin))
    # NB keep the mask in the FLAT (npol, nsamp) layout via jnp.repeat
    # (uniform repeat lowers to broadcast+reshape, not a gather): a
    # (npol, nwin, nkurto)-view multiply would break XLA's fusion with
    # the channelizer's (npol, nspec, nfft) read of the masked array.
    if block_keep is not None:
        good2 = jnp.logical_and(good2,
                                jnp.repeat(block_keep, wpf)[None, :])
    masked = jnp.where(jnp.repeat(good2, nkurto, axis=1), x, 0.0)
    weights = jnp.mean(
        good2.astype(x.dtype).reshape(npol, nblk, wpf), axis=-1)
    return masked, weights


def sample_histogram(u: jax.Array, nbins: int = 256) -> jax.Array:
    """Per-polarization raw-sample histograms (the DOHISTO diagnostic,
    ref histogram kernel src/pb_kernels.cu:321-336).
    u: (npol, nsamp) uint8 -> (npol, nbins) int32.

    Computed as an equality-compare reduction (XLA streams the virtual
    (nsamp, nbins) one-hot through the sum) instead of jnp.bincount's
    scatter."""
    ui = u.astype(jnp.int32)
    bins = jnp.arange(nbins, dtype=jnp.int32)
    return jnp.sum((ui[:, :, None] == bins[None, None, :])
                   .astype(jnp.int32), axis=1)


class FramedKurtosisResult(NamedTuple):
    """rfi_excise_framed output: everything stays in the DFT's frame
    layout so no f32 relayout is ever materialized."""

    xf: jax.Array        # (b, n1, n2) float32 converted voltages
    row_keep: jax.Array  # (b, n1) bool; False rows are excised
    weights: jax.Array   # (npol, nblk) surviving fraction per FFT block
    dag: jax.Array       # (nwin,) pol-combined fine-window TS
    dag_fb: jax.Array    # (nblk,) pol-combined block TS
    pow_w: jax.Array     # (npol, nwin) fine-window power
    kur_w: jax.Array     # (npol, nwin) fine-window kurtosis


@partial(jax.jit, static_argnames=("npol", "nkurto", "nfft",
                                   "dag_fb_thresh"))
def rfi_excise_framed(xb: jax.Array, npol: int, nkurto: int, nfft: int,
                      dag_thresh: float = C.DAG_THRESH,
                      dag_fb_thresh: float = 0.0) -> FramedKurtosisResult:
    """rfi_excise computed IN the Cooley-Tukey frame layout.

    xb: (b, n1, n2) uint8 with b = npol * nspec, frame sample index
    = i1 * n2 + i2 (exactly the reshape ops/channelize.matmul_rfft_*
    performs) and nkurto % n2 == 0, nfft % nkurto == 0.

    Why: the flat rfi_excise forces the (npol, nsamp) float voltages
    through TWO physical tile relayouts per segment — (npol, nwin,
    nkurto) for the window reductions and (b, n1, n2) for the DFT (the
    1.6 MB blocks change shape, a full device-memory round trip each).  Reshaping
    the uint8 BYTES once instead, a fine window is exactly
    nkurto/n2 consecutive n1-rows: the window moments come from lane
    sums fused into the x^2/x^4 pass plus one tiny (n1, wpf) pooling
    matmul, and the excision mask is a per-row boolean the caller's
    jnp.where fuses straight into the DFT's stage-1 operand read.
    Identical math to rfi_excise up to f32 summation order (parity
    asserted in tests/test_ops.py).

    Returns converted voltages, row mask, and the same stats tuple as
    rfi_excise (see FramedKurtosisResult).
    """
    from vlite_fast.ops.unpack import convert_uint8

    b, n1, n2 = xb.shape
    nspec = b // npol
    rpw = nkurto // n2                 # frame rows per fine window
    wpf = nfft // nkurto               # fine windows per FFT block
    nwin = nspec * wpf
    xf = convert_uint8(xb)
    x2 = xf * xf
    # both row moments come out of ONE fused pass over the voltages
    s2 = jnp.sum(x2, axis=2)           # (b, n1)
    s4 = jnp.sum(x2 * x2, axis=2)      # (b, n1)
    pool = jnp.asarray(np.kron(np.eye(wpf, dtype=np.float32),
                               np.ones((rpw, 1), np.float32)))  # (n1, wpf)
    hp = jax.lax.Precision.HIGHEST
    m2 = jnp.dot(s2, pool, precision=hp) * (1.0 / nkurto)   # (b, wpf)
    m4 = jnp.dot(s4, pool, precision=hp) * (1.0 / nkurto)
    m2 = m2.reshape(npol, nwin)
    m4 = m4.reshape(npol, nwin)
    kur = m4 / jnp.where(m2 == 0, 1.0, m2 * m2)
    kur = jnp.where(m2 == 0, 0.0, kur)
    dag = dagostino_ts(kur, nkurto)
    pow_b, kur_b = block_stats(m2, kur, dag, wpf, dag_thresh)
    dag_fb = dagostino_ts(kur_b, nfft)
    good = dag < dag_thresh                                  # (nwin,)
    if dag_fb_thresh > 0:
        good = jnp.logical_and(good,
                               jnp.repeat(dag_fb < dag_fb_thresh, wpf))
    good2 = jnp.broadcast_to(good, (npol, nwin))
    weights = jnp.mean(
        good2.astype(xf.dtype).reshape(npol, nspec, wpf), axis=-1)
    row_keep = jnp.repeat(good2.reshape(b, wpf), rpw, axis=1)  # (b, n1)
    return FramedKurtosisResult(xf, row_keep, weights, dag, dag_fb,
                                m2, kur)


def row_keep_from_dag(dag: jax.Array, dag_fb: jax.Array, npol: int,
                      nkurto: int, nfft: int, n2: int,
                      dag_thresh: float = C.DAG_THRESH,
                      dag_fb_thresh: float = 0.0) -> jax.Array:
    """The apply_mask window gate as a per-FRAME-ROW boolean (b, n1)
    for the frame-layout select (the 'mixed' front: stats computed
    flat, mask applied in the DFT's (b, n1, n2) layout).  Same gate
    semantics as apply_mask/rfi_excise_framed."""
    nwin = dag.shape[0]
    wpf = nfft // nkurto
    rpw = nkurto // n2
    good = dag < dag_thresh
    if dag_fb_thresh > 0:
        good = jnp.logical_and(good,
                               jnp.repeat(dag_fb < dag_fb_thresh, wpf))
    good2 = jnp.broadcast_to(good, (npol, nwin))
    return jnp.repeat(good2.reshape(npol * (nwin // wpf), wpf),
                      rpw, axis=1)


@partial(jax.jit, static_argnames=("nkurto", "nfft", "fake",
                                   "dag_fb_thresh"))
def rfi_excise(x: jax.Array, nkurto: int, nfft: int,
               dag_thresh: float = C.DAG_THRESH,
               fake: bool = False,
               dag_fb_thresh: float = 0.0) -> KurtosisResult:
    """Full RFI stage: fine stats -> TS -> block stats -> mask + weights.

    Mirrors the launch sequence at src/process_baseband.cu:1160-1216.

    dag_fb_thresh > 0 additionally zero-weights WHOLE FFT blocks whose
    block-scale D'Agostino TS exceeds it (the compute_dagostino2 gate the
    reference computes but leaves commented out, pb_kernels.cu:255-256;
    here it is a live, tested knob — broadband bursty RFI that evades the
    3.9 us fine windows still pulls the 12500-sample block TS).
    """
    pow_w, kur_w = window_stats(x, nkurto)
    dag = dagostino_ts(kur_w, nkurto)
    wpf = nfft // nkurto
    pow_b, kur_b = block_stats(pow_w, kur_w, dag, wpf, dag_thresh)
    dag_fb = dagostino_ts(kur_b, nfft)
    keep = ((dag_fb < dag_fb_thresh)
            if dag_fb_thresh > 0 and not fake else None)
    masked, weights = apply_mask(x, dag, nkurto, nfft, dag_thresh, fake,
                                 block_keep=keep)
    return KurtosisResult(masked, weights, dag, dag_fb, pow_w, kur_w)
