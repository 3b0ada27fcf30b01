"""Channelization: batched real FFT filterbank (+ WOLA polyphase variant).

The reference channelizes with batched cuFFT R2C plans of NFFT=12500 points,
2048 transforms per 100 ms chunk (src/process_baseband.cu:593-598,1222-1224).
Two channelizers do the same here: 'fft' (XLA's FFT, which is cuFFT on the
GPU) and the default 'matmul' (matmul_rfft: the DFT factored as 100x125
Cooley-Tukey stages that run as batched matmuls).  chip_smoke.py times
both on the card and checks each against the f32 oracle (PERF.md).

The polyphase (weighted overlap-add) variant mirrors the offline
polyphase_filterbank in the reference analysis code
(analysis/baseband.py:1207-1238) and gives the sharper channel response used
for parity configs; it costs one extra elementwise multiply + tap sum.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np


def channelize(x: jax.Array, nfft: int, method: str = "fft",
               precision: str = "highest",
               exact_bf16_input: bool = False,
               stage2: str = "direct") -> jax.Array:
    """(npol, nsamp) real voltages -> (npol, nspec, nchan) complex spectra.

    nchan = nfft//2 + 1; spectrum s covers samples [s*nfft, (s+1)*nfft).

    method: 'fft' uses XLA's native FFT (cuFFT on the GPU); 'matmul'
    uses the Cooley-Tukey matmul decomposition (see matmul_rfft).
    """
    npol, nsamp = x.shape
    frames = x.reshape(npol, nsamp // nfft, nfft)
    if method == "matmul":
        # planes formulation: 6 real matmuls instead of complex ones
        return matmul_rfft_planes(frames, nfft, precision=precision,
                                  exact_bf16_input=exact_bf16_input,
                                  stage2=stage2)
    return jnp.fft.rfft(frames, axis=-1)


# What each dft_precision name asks of the DFT matmuls.  'high' is three
# bf16 passes (~4e-6 relative error): Precision.HIGH alone lets XLA run
# the float32 product in TF32 on the GPU (~3e-4), which misses the
# chain's 2-bit agreement bar against the f32 oracle (PERF.md).
_DOT_PRECISION = {"high": jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3,
                  "highest": jax.lax.Precision.HIGHEST}


def dot_precision(precision):
    """A dft_precision name -> the einsum precision argument."""
    return _DOT_PRECISION.get(precision, precision) \
        if isinstance(precision, str) else precision


@lru_cache(maxsize=8)
def _ct_split(nfft: int) -> tuple:
    """Factor nfft = n1 * n2 with the factors as close as possible."""
    best = None
    f = int(np.sqrt(nfft))
    for n1 in range(f, 0, -1):
        if nfft % n1 == 0:
            best = (n1, nfft // n1)
            break
    if best is None or best[0] == 1:
        raise ValueError(f"nfft {nfft} has no useful factorization")
    return best


@lru_cache(maxsize=8)
def _ct_tables(nfft: int) -> tuple:
    """DFT + twiddle matrices for the two-stage Cooley-Tukey transform
    (complex64 numpy; converted to device constants at trace time)."""
    n1, n2 = _ct_split(nfft)
    i1 = np.arange(n1)
    i2 = np.arange(n2)
    w1 = np.exp(-2j * np.pi * np.outer(i1, i1) / n1).astype(np.complex64)
    tw = np.exp(-2j * np.pi * np.outer(i1, i2) / nfft).astype(np.complex64)
    w2 = np.exp(-2j * np.pi * np.outer(i2, i2) / n2).astype(np.complex64)
    return w1, tw, w2


def matmul_rfft(frames: jax.Array, nfft: int,
                precision: str = "highest") -> jax.Array:
    """rfft via two matmul DFT stages (Cooley-Tukey, decimation
    in time): with n = n2*m1 + m2, k = k1 + n1*k2,

      A[k1, m2] = sum_m1 x[m1, m2] W_n1^{m1 k1}      (matmul over m1)
      B = A * W_nfft^{m2 k1}                          (twiddle)
      X[k1 + n1 k2] = sum_m2 B[k1, m2] W_n2^{m2 k2}   (matmul over m2)

    frames: (..., nfft) real float32 -> (..., nfft//2+1) complex64.
    FLOP cost is ~n1+n2 per point instead of log(nfft), which matrix
    units absorb; accuracy with 'highest' precision is ~1e-6 relative.
    """
    n1, n2 = _ct_split(nfft)
    w1, tw, w2 = _ct_tables(nfft)
    batch = frames.shape[:-1]
    nchan = nfft // 2 + 1
    # rfft only needs bins k <= nfft//2, i.e. k2 <= nfft//2 // n1 — slice
    # the outer DFT matrix so stage 2 computes ~half the work
    n2_out = nfft // 2 // n1 + 1
    x = frames.reshape(-1, n1, n2).astype(jnp.float32)
    precision = dot_precision(precision)
    a = jnp.einsum("bnm,nk->bkm", x, jnp.asarray(w1), precision=precision)
    b = a * jnp.asarray(tw)[None]
    # output layout (b, k2, k1) straight from the einsum: the linear bin
    # k = k1 + n1*k2 is then a plain reshape, no device transpose
    part = jnp.einsum("bkm,mj->bjk", b, jnp.asarray(w2[:, :n2_out]),
                      precision=precision)
    lin = part.reshape(-1, n2_out * n1)
    return lin[:, :nchan].reshape(*batch, nchan)


@lru_cache(maxsize=8)
def _ct_tables_planes(nfft: int) -> tuple:
    """The _ct_tables matrices split into float32 real/imag planes (stage-2
    matrix pre-sliced to the rfft-needed k2 rows)."""
    n1, n2 = _ct_split(nfft)
    w1, tw, w2 = _ct_tables(nfft)
    n2_out = nfft // 2 // n1 + 1
    w2s = w2[:, :n2_out]
    return tuple(np.ascontiguousarray(p) for p in
                 (w1.real, w1.imag, tw.real, tw.imag, w2s.real, w2s.imag))


@lru_cache(maxsize=8)
def _ct_tables_gauss(nfft: int) -> tuple:
    """Derived stage-2 planes for the Gauss 3-multiplication complex
    product: (w2r, w2i - w2r, w2i + w2r)."""
    *_, w2r, w2i = _ct_tables_planes(nfft)
    return (w2r, np.ascontiguousarray(w2i - w2r),
            np.ascontiguousarray(w2i + w2r))


def matmul_rfft_planes(frames: jax.Array, nfft: int,
                       precision: str = "highest",
                       exact_bf16_input: bool = False,
                       stage2: str = "direct") -> jax.Array:
    """matmul_rfft computed on explicit float32 real/imag PLANES.

    jnp.einsum(real, complex) promotes the voltages to complex64, so the
    first Cooley-Tukey stage runs as a full complex x complex product — 4
    real matmuls (two against a zero imaginary part) and 2x the input
    reads.  Splitting the DFT matrices into real/imag planes does the same
    transform in 6 real matmuls total (2 first-stage + 4 second-stage)
    with every array real float32; only the final
    result is assembled into complex64.

    exact_bf16_input: promise that `frames` values are EXACTLY
    bf16-representable (true for 8-bit quantized voltages k/128 — an
    8-bit significand holds any k*2^-7, |k| <= 255 — and they stay exact
    through kurtosis masking, which only zeroes).  Then bf16x3's
    x_lo*w_hi term is identically zero and stage 1 at precision='high'
    runs as TWO bf16 passes against a hi/lo split of the DFT matrix —
    same accuracy, 2/3 the stage-1 matmul work.  Stage 2's inputs are full
    f32 sums, so it keeps the standard 3-pass emulation.
    """
    n1, n2 = _ct_split(nfft)
    batch = frames.shape[:-1]
    x = frames.reshape(-1, n1, n2).astype(jnp.float32)
    out = matmul_rfft_framed(x, nfft, precision=precision,
                             exact_bf16_input=exact_bf16_input,
                             stage2=stage2)
    return out.reshape(*batch, out.shape[-1])


def matmul_rfft_framed(x: jax.Array, nfft: int,
                       precision: str = "highest",
                       exact_bf16_input: bool = False,
                       stage2: str = "direct") -> jax.Array:
    """The matmul_rfft_planes core on voltages ALREADY in the
    Cooley-Tukey frame layout: x (b, n1, n2) float32 -> (b, nchan)
    complex64.  Callers that keep the chain in frame layout end-to-end
    (models/baseband_dsp framed front, ops/kurtosis.rfi_excise_framed)
    enter here directly, so the (…, nfft) -> (…, n1, n2) reshape — a
    physical tile relayout of every 1.6 MB voltage block — never
    happens on f32 data."""
    n1, n2 = _ct_split(nfft)
    w1r, w1i, twr, twi, w2r, w2i = map(jnp.asarray, _ct_tables_planes(nfft))
    nchan = nfft // 2 + 1
    n2_out = nfft // 2 // n1 + 1
    prec = dot_precision(precision)
    if exact_bf16_input and precision == "high":
        # arrays stay f32 (CPU backends cannot execute bf16 dots); the
        # hi/lo planes hold bf16-REPRESENTABLE values, so each einsum is
        # exact in one bf16 pass where DEFAULT precision means bf16
        def _stage1(w):
            w_hi = w.astype(jnp.bfloat16).astype(jnp.float32)
            w_lo = w - w_hi
            return (jnp.einsum("bnm,nk->bkm", x, w_hi,
                               precision=jax.lax.Precision.DEFAULT)
                    + jnp.einsum("bnm,nk->bkm", x, w_lo,
                                 precision=jax.lax.Precision.DEFAULT))

        ar = _stage1(w1r)
        ai = _stage1(w1i)
    else:
        ar = jnp.einsum("bnm,nk->bkm", x, w1r, precision=prec)
        ai = jnp.einsum("bnm,nk->bkm", x, w1i, precision=prec)
    br = ar * twr - ai * twi
    bi = ar * twi + ai * twr
    if stage2 == "gauss":
        # Gauss 3-multiplication complex product: one fewer stage-2
        # matmul (3 vs 4 einsums) at ~the same rounding level (each
        # product keeps the full `precision` emulation; the extra
        # elementwise pre-adds fuse into the matmul operands).
        #   m1 = (br+bi)w2r, m2 = br(w2i-w2r), m3 = bi(w2i+w2r)
        #   pr = m1 - m3, pi = m1 + m2
        g2r, g2d, g2s = map(jnp.asarray, _ct_tables_gauss(nfft))
        m1 = jnp.einsum("bkm,mj->bjk", br + bi, g2r, precision=prec)
        m2 = jnp.einsum("bkm,mj->bjk", br, g2d, precision=prec)
        m3 = jnp.einsum("bkm,mj->bjk", bi, g2s, precision=prec)
        pr = m1 - m3
        pi = m1 + m2
    else:
        pr = (jnp.einsum("bkm,mj->bjk", br, w2r, precision=prec)
              - jnp.einsum("bkm,mj->bjk", bi, w2i, precision=prec))
        pi = (jnp.einsum("bkm,mj->bjk", br, w2i, precision=prec)
              + jnp.einsum("bkm,mj->bjk", bi, w2r, precision=prec))
    lin_r = pr.reshape(-1, n2_out * n1)[:, :nchan]
    lin_i = pi.reshape(-1, n2_out * n1)[:, :nchan]
    return jax.lax.complex(lin_r, lin_i)


@lru_cache(maxsize=8)
def _pfb_window(ntap: int, nfft: int) -> np.ndarray:
    """Sinc-Hamming prototype filter, normalized so white-noise output
    POWER matches the plain length-nfft channelizer: a WOLA spectrum sums
    ntap*nfft weighted samples, so per-bin noise power is sum(w^2) times
    the per-sample variance — sum(w^2) must equal nfft (a sum(w^2) =
    ntap*nfft normalization made the PFB path exactly ntap x hotter than
    the FFT path, verified on white noise)."""
    n = ntap * nfft
    t = (np.arange(n) - n / 2 + 0.5) / nfft
    w = np.sinc(t) * np.hamming(n)
    w *= np.sqrt(nfft / np.sum(w ** 2))
    return w.astype(np.float32)


def pfb_weights(w_ext: jax.Array, ntap: int, nfft: int) -> jax.Array:
    """WOLA-window kurtosis-weight bookkeeping.

    The FFT path's weights are 'surviving fraction of fine windows per
    nfft block' (ops/kurtosis.apply_mask, ref pb_kernels.cu:243-295).  A
    WOLA spectrum j instead draws ntap consecutive blocks [j, j+ntap)
    through the prototype window, so its effective surviving fraction is
    the tap-ENERGY-weighted mean of those blocks' fractions (the energy of
    window tap t sets how much block j+t contributes to spectrum j's
    power, hence to its bias/variance correction downstream).

    w_ext: (npol, nblk + ntap - 1) per-block fractions INCLUDING the
    ntap-1 carried blocks from the previous segment, oldest first.
    Returns (npol, nblk) per-spectrum weights.
    """
    win = jnp.asarray(_pfb_window(ntap, nfft))
    e = jnp.sum(win.reshape(ntap, nfft) ** 2, axis=1)
    e = e / jnp.sum(e)                                   # (ntap,)
    npol, next_ = w_ext.shape
    nblk = next_ - (ntap - 1)
    idx = jnp.arange(nblk)[:, None] + jnp.arange(ntap)[None, :]
    return jnp.sum(w_ext[:, idx] * e[None, None, :], axis=-1)


def polyphase_channelize(x: jax.Array, nfft: int, ntap: int = 4,
                         method: str = "fft",
                         precision: str = "highest") -> jax.Array:
    """WOLA polyphase filterbank (ref analysis/baseband.py:1207-1238).

    x: (npol, nsamp); output (npol, nspec, nchan) where
    nspec = nsamp//nfft - (ntap - 1): each spectrum consumes ntap*nfft
    samples advanced by nfft.  method as in channelize().
    """
    npol, nsamp = x.shape
    nspec_raw = nsamp // nfft
    nspec = nspec_raw - (ntap - 1)
    win = jnp.asarray(_pfb_window(ntap, nfft)).reshape(ntap, nfft)
    frames = x.reshape(npol, nspec_raw, nfft)
    # ntap consecutive frames per output spectrum via STATIC slices (a
    # fancy-index gather here would lower to an XLA gather)
    wola = sum(frames[:, t:t + nspec] * win[t]
               for t in range(ntap))
    if method == "matmul":
        return matmul_rfft_planes(wola, nfft, precision=precision)
    return jnp.fft.rfft(wola, axis=-1)
