"""Gulp-based single-pulse search engine (the heimdall_stream role).

Drives ops.dedisperse over a streaming filterbank in overlapping gulps,
producing Candidate records compatible with the coincidencer
(runtime/trigger.py).  Ref invocation being replaced:
scripts/start_heimdall_single_antenna:21 (-nsamps_gulp 30720 -dm 2 1000
-boxcar_max 64 -zap_chans ... -coincidencer host:27555).
"""

from __future__ import annotations

from functools import partial
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from vlite_fast import backend
from vlite_fast.config import SearchConfig
from vlite_fast.ops import dedisperse as dd
from vlite_fast.ops import quantize as q_ops


def make_dm_grid(scfg: SearchConfig, tsamp: float,
                 freqs_mhz: np.ndarray) -> np.ndarray:
    """DM trial placement per config.

    'tol' (production default): the dedisp/heimdall -dm_tol scheme — step
    sized so a half-step DM error costs at most `dm_tol` in S/N
    (ops/dedisperse.dm_grid_tol); trial count follows the tolerance.  The
    grid is padded (extending past dm_max by the final step) to a multiple
    of 128 so the subband engines keep uniform DM batches.
    'linear': scfg.ndm evenly spaced trials.
    """
    if scfg.dm_grid_mode != "tol":
        return dd.dm_grid(scfg.dm_min, scfg.dm_max, scfg.ndm)
    dms = dd.dm_grid_tol(scfg.dm_min, scfg.dm_max, tsamp,
                         np.asarray(freqs_mhz), tol=scfg.dm_tol)
    pad = (-len(dms)) % 128
    if pad and len(dms) >= 2:
        step = dms[-1] - dms[-2]
        dms = np.concatenate([dms, dms[-1] + step * np.arange(1, pad + 1)])
    return dms


def resolve_engine(engine: str) -> str:
    """'auto' -> the engine mapped to JAX's platform
    (backend.dedisp_engine); any other value is taken as given."""
    if engine != "auto":
        return engine
    return backend.dedisp_engine()


def dedisperse(engine: str, fb: jax.Array, plan: dd.DedispPlan,
               ntime_out: int) -> jax.Array:
    """(ntime, nchan) float32 -> (ndm, ntime_out) DM-time plane through
    the named engine ('pallas', 'fourier' or 'subband')."""
    if engine == "pallas":
        from vlite_fast.ops import dedisperse_pallas as ddp
        return ddp.dedisperse_pallas(fb, plan, ntime_out)
    if engine == "fourier":
        return dd.dedisperse_fourier(fb, plan, ntime_out)
    if engine == "subband":
        return dd.dedisperse(fb, plan, ntime_out)
    raise ValueError(f"unknown dedispersion engine {engine!r}")


def boxcar_widths(boxcar_max: int) -> tuple:
    w, out = 1, []
    while w <= boxcar_max:
        out.append(w)
        w *= 2
    return tuple(out)


def effective_nbands(ndm: int, requested: int) -> int:
    """The per-DM-band top-k quota layout (pack_topk_banded) requires
    nbands | ndm; fall back to one global band otherwise.  This is THE
    single definition both the device packer and the host decoder use —
    they must agree or indices land in the wrong DM band."""
    return requested if requested >= 1 and ndm % requested == 0 else 1


def pack_topk_banded(snr: jax.Array, k: int, nbands: int,
                     thresh: float) -> jax.Array:
    """(nw, ndm, ntime) S/N cube -> (2, nbands*kb + 1) int32 packed
    crossings, kb = k // nbands slots per contiguous DM band.

    Top-k is taken PER DM BAND rather than globally: a zero-DM RFI storm
    producing tens of thousands of bright crossings can then saturate
    only its own band's quota and can never evict a genuine high-DM
    pulse from the fixed-size device->host return (heimdall's analogous
    guard is its giant-cluster limits).  The final column carries the
    in-graph count of threshold crossings so the host can meter
    saturation without fetching the cube.

    approx_max_k lowers to an exact top-k on the CPU and the GPU (XLA's
    TopK), so recall_target has no effect there.  chip_smoke.py times
    this stage on the card.

    Row 0: bitcast float32 S/N (last col: crossing count, plain int32).
    Row 1: flat indices WITHIN each band, bands concatenated in order.
    Everything ships as ONE int32 array: a single host fetch per gulp
    instead of two/three (each fetch pays a full round-trip latency).
    """
    nw, ndm, ntime = snr.shape
    nbands = effective_nbands(ndm, nbands)
    kb = max(1, min(k // nbands, nw * (ndm // nbands) * ntime))
    count = jnp.sum(snr > jnp.float32(thresh)).astype(jnp.int32)
    banded = snr.reshape(nw, nbands, ndm // nbands, ntime)
    banded = jnp.swapaxes(banded, 0, 1).reshape(nbands, -1)
    vals, idx = jax.lax.approx_max_k(banded, kb, recall_target=0.95)
    row0 = jnp.concatenate([
        jax.lax.bitcast_convert_type(vals.reshape(-1), jnp.int32),
        count[None]])
    row1 = jnp.concatenate([idx.reshape(-1).astype(jnp.int32),
                            jnp.zeros((1,), jnp.int32)])
    return jnp.stack([row0, row1])


def decode_crossings(packed: np.ndarray, nw: int, ndm: int, ntime: int,
                     nbands: int, snr_thresh: float):
    """Host-side inverse of pack_topk_banded.

    Returns (vals, hits, n_crossings, saturated_bands): hits is (n, 3)
    int64 [width_idx, dm_idx, t_idx] for crossings above snr_thresh;
    n_crossings the in-graph count of the WHOLE cube's crossings; a band
    is saturated when every one of its kb returned slots is above
    threshold (its (kb+1)-th crossing was dropped on device).
    """
    arr = np.asarray(packed)
    n_crossings = int(arr[0, -1])
    vals = arr[0, :-1].view(np.float32)
    idx = arr[1, :-1].astype(np.int64)
    nbands = effective_nbands(ndm, nbands)
    kb = vals.size // nbands
    vals = vals.reshape(nbands, kb)
    idx = idx.reshape(nbands, kb)
    dmb = ndm // nbands
    # a band whose every returned slot crossed threshold dropped its
    # (kb+1)-th crossing on device — UNLESS kb covers the entire band
    # cube, in which case nothing can have been dropped
    if kb >= nw * dmb * ntime:
        saturated = 0
    else:
        saturated = int((vals.min(axis=1) > snr_thresh).sum())
    keep = vals > snr_thresh
    band_of = np.broadcast_to(np.arange(nbands)[:, None], vals.shape)
    v, j, b = vals[keep], idx[keep], band_of[keep]
    hits = np.stack([j // (dmb * ntime),
                     b * dmb + (j // ntime) % dmb,
                     j % ntime], axis=1)
    return v, hits, n_crossings, saturated


@partial(jax.jit, static_argnames=("engine", "widths", "k", "nbit",
                                   "nchan", "nbands", "thresh"))
def _device_gulp(fb, plan, *, engine: str, widths: tuple, k: int,
                 nbit: int, nchan: int, nbands: int, thresh: float):
    """One fused device program per gulp: [dequantize ->] dedisperse ->
    boxcar S/N -> banded top-k crossings.  Cached across gulps (all
    arguments that vary are traced; geometry is static)."""
    if nbit:
        fb = q_ops.dequantize(fb, nbit)
        fb = fb.reshape(fb.shape[0], -1)[:, :nchan]
    fb = fb.astype(jnp.float32)
    ntime_out = fb.shape[0] - plan.max_delay
    dmt = dedisperse(engine, fb, plan, ntime_out)
    snr = dd.boxcar_snr(dmt, plan.nchan_eff, widths)
    return pack_topk_banded(snr, k, nbands, thresh)


class SinglePulseSearch:
    """One beam's search engine.  Stateless across gulps except the plan."""

    def __init__(self, scfg: SearchConfig, tsamp: float,
                 freqs_mhz: np.ndarray, nsub: int = 0, nbatch: int = 0):
        self.scfg = scfg
        self.tsamp = float(tsamp)
        self.freqs_mhz = np.asarray(freqs_mhz)
        self.dms = make_dm_grid(scfg, self.tsamp, self.freqs_mhz)
        self.widths = boxcar_widths(scfg.boxcar_max)
        self.plan = dd.make_plan(self.dms, self.freqs_mhz, self.tsamp,
                                 nsub=nsub or scfg.nsub,
                                 nbatch=nbatch or scfg.nbatch,
                                 zap_ranges=scfg.zap_ranges)
        # per-DM-band top-k quota (see pack_topk_banded); grids are padded
        # to multiples of 128 so the default 8 always divides in production
        self.nbands = effective_nbands(len(self.dms), scfg.topk_dm_bands)
        # decoded from the last gulp's packed return: total in-cube
        # threshold crossings and how many DM bands overflowed their quota
        self.last_gulp_stats = {"n_crossings": 0, "saturated_bands": 0}

    @property
    def overlap(self) -> int:
        """Lookahead samples a gulp needs beyond its own span (the max DM
        delay across the band — heimdall's gulp overlap)."""
        return self.plan.max_delay

    def snr_cube(self, fb_block: np.ndarray) -> jnp.ndarray:
        """(gulp+overlap, nchan) float32 -> (nwidth, ndm, gulp) S/N."""
        fb = jnp.asarray(fb_block, dtype=jnp.float32)
        ntime_out = fb.shape[0] - self.plan.max_delay
        dmt = dedisperse(resolve_engine(self.scfg.engine), fb, self.plan,
                         ntime_out)
        return dd.boxcar_snr(dmt, self.plan.nchan_eff, self.widths)

    def _top_crossings(self, fb_dev, nbit: int = 0):
        """Device-side gulp search: dedisperse + boxcar S/N + top-k of the
        flattened cube.  Only ~20k (value, index) pairs ever leave the
        device — the full S/N cube at production geometry is ~0.9 GB and
        must never cross PCIe per gulp.

        fb_dev is (full, nchan) float32, or packed uint8 rows when
        nbit > 0 (dequantized on device — 16x less transfer at 2 bit).
        """
        k = self.scfg.topk or min(16 * self.scfg.max_candidates, 20000)
        packed = _device_gulp(
            fb_dev, self.plan, engine=resolve_engine(self.scfg.engine),
            widths=self.widths, k=k, nbit=nbit, nchan=len(self.freqs_mhz),
            nbands=self.nbands, thresh=float(self.scfg.snr_thresh))
        ntime_out = (fb_dev.shape[0] - self.plan.max_delay)
        return packed, (len(self.widths), len(self.dms), ntime_out)

    def _cands_from_crossings(self, packed, shape, t_offset, nvalid
                              ) -> List[dd.Candidate]:
        # one fetch for the packed (2, nbands*kb + 1) int32 crossings;
        # see pack_topk_banded for the layout and the quota policy
        nw, ndm, ntime = [int(s) for s in shape]
        vals, hits, n_cross, saturated = decode_crossings(
            packed, nw, ndm, ntime, self.nbands, self.scfg.snr_thresh)
        self.last_gulp_stats = {"n_crossings": n_cross,
                                "saturated_bands": saturated}
        cands = dd.cluster_hits(
            hits, vals, self.dms, self.tsamp, widths=self.widths,
            t_offset=t_offset, max_cands=self.scfg.max_candidates)
        limit = t_offset + nvalid      # drop anything inside the padding
        return [c for c in cands if c.peak_idx < limit]

    def search_gulp(self, fb_block: np.ndarray,
                    t_offset: int = 0) -> List[dd.Candidate]:
        """Search one gulp.  Blocks are zero-padded to the standard
        (gulp + overlap) length so every gulp — including ragged stream
        tails — reuses ONE compiled program (a fresh shape would cost a
        compile mid-observation)."""
        full = self.scfg.gulp_samps + self.overlap
        nvalid = fb_block.shape[0] - self.overlap
        if fb_block.shape[0] < full:
            pad = np.zeros((full - fb_block.shape[0], fb_block.shape[1]),
                           fb_block.dtype)
            fb_block = np.concatenate([fb_block, pad], axis=0)
        # ship the caller's dtype and cast to f32 IN-GRAPH (_device_gulp):
        # the coadd stream stores float16, so converting on the host
        # would double the block's host->device bytes
        packed, shape = self._top_crossings(jnp.asarray(fb_block))
        return self._cands_from_crossings(packed, shape, t_offset,
                                          nvalid)

    def search_gulp_packed(self, packed_block: np.ndarray, nbit: int,
                           t_offset: int = 0) -> List[dd.Candidate]:
        """Search one gulp from PACKED filterbank rows (time, nbytes):
        the bytes ship to the device as-is and are dequantized in-graph —
        at 2 bit that is 16x less host->device traffic than unpacked
        float32."""
        full = self.scfg.gulp_samps + self.overlap
        nvalid = packed_block.shape[0] - self.overlap
        if packed_block.shape[0] < full:
            # pad with the quantizer's near-zero level in every slot
            fill = q_ops.NEAR_ZERO_FILL[nbit]
            pad = np.full((full - packed_block.shape[0],
                           packed_block.shape[1]), fill, np.uint8)
            packed_block = np.concatenate([packed_block, pad], axis=0)
        crossings, shape = self._top_crossings(jnp.asarray(packed_block),
                                               nbit=nbit)
        return self._cands_from_crossings(crossings, shape, t_offset,
                                          nvalid)

    def search_gulp_device(self, packed_dev, nbit: int, t_offset: int,
                           nvalid: int) -> List[dd.Candidate]:
        """Search one gulp whose PACKED rows are already device-resident.

        The streaming chain produces the quantized filterbank ON the
        device; re-uploading those bytes for the search (search_gulp_
        packed) costs a host->device round trip per gulp (~38 MB at
        production geometry).  Here the caller hands the accumulated
        device blocks directly: zero upload, only top-k crossings return.

        packed_dev must already be exactly (gulp + overlap, nbytes); the
        pipeline pads ragged flush tails ON DEVICE to this shape
        (DeviceGulpStream.window pad_to).  search_gulp_packed remains the
        fallback only for windows that aren't device-resident or don't
        start on a stored block boundary.
        """
        full = self.scfg.gulp_samps + self.overlap
        if int(packed_dev.shape[0]) != full:
            raise ValueError(f"device gulp must be padded to {full} rows")
        crossings, shape = self._top_crossings(packed_dev, nbit=nbit)
        return self._cands_from_crossings(crossings, shape, t_offset,
                                          nvalid)

    def search_stream(self, fb: np.ndarray) -> List[dd.Candidate]:
        """Search a long (ntime, nchan) filterbank in overlapping gulps."""
        gulp = self.scfg.gulp_samps
        cands: List[dd.Candidate] = []
        t = 0
        ntime = fb.shape[0]
        while t < ntime:
            block = fb[t:t + gulp + self.overlap]
            if block.shape[0] <= self.overlap + max(self.widths):
                break
            # pad the ragged tail so compiled shapes stay static per gulp len
            cands.extend(self.search_gulp(block, t_offset=t))
            t += gulp
        return cands


def filterbank_from_packed(packed: np.ndarray, nbit: int,
                           nchanout: int) -> np.ndarray:
    """Unpack a quantized filterbank block (time, bytes) -> (time, chan)
    float, recentered so noise is ~zero-mean (undo quantizer offsets).

    Pure numpy — a host-side reader must not bounce bytes through the
    accelerator (the in-graph inverse for device-side search is
    ops.quantize.dequantize, used by search_gulp_packed).

    The 2-bit mapping uses the expectations of the chi^2_16-optimized
    levels; for search purposes a linear re-map of level -> value suffices
    (same as heimdall reading 2-bit sigproc data).
    """
    packed = np.asarray(packed, dtype=np.uint8)
    if nbit == 8:
        lev = packed
    else:
        per_byte = 8 // nbit
        shifts = np.arange(per_byte, dtype=np.uint8) * nbit
        mask = np.uint8((1 << nbit) - 1)
        lev = ((packed[..., None] >> shifts) & mask).reshape(
            packed.shape[0], -1)
    lev = lev.reshape(packed.shape[0], -1)[:, :nchanout]
    if nbit == 2:
        # approximate inverse of the 2-bit thresholds: level centroids of a
        # unit normal cut at (-0.6109, 0.3970, 1.4050)
        centroids = np.array([-1.24, -0.098, 0.85, 1.94], np.float32)
        return centroids[lev.astype(np.int32)]
    if nbit == 4:
        return (lev.astype(np.float32) - 7.5) * np.float32(0.3188)
    return (lev.astype(np.float32) - 127.5) * np.float32(0.02957)
