"""Incoherent dedispersion + boxcar matched filtering (heimdall's role).

The reference delegates its single-pulse search to the external heimdall/
dedisp GPU binaries (scripts/start_heimdall_single_antenna:21: DM 2-1000,
boxcar_max 64, 24 s gulps).  This module reimplements that engine in XLA
(ops/dedisperse_pallas holds the same decomposition as a GPU kernel):

* the DM-trial transform is a two-stage *subband* shift-and-sum (the same
  decomposition the dedisp library uses): stage 1 dedisperses channels
  within each subband for a coarse grid of DM batches, stage 2 combines the
  per-subband time series with full-resolution DM shifts.  This cuts the
  shifted-read traffic by ~nchan/nsub versus direct shift-and-sum; the
  within-subband quantization error at the default (nsub=128, nbatch=128)
  is <=4 samples worst-case in the bottom-band subbands (zero in exact
  mode, nbatch=ndm) — the same accuracy class as the dedisp library's
  subband scheme at heimdall's dm_tol.
* shifts are expressed as take_along_axis reads over a time-padded block —
  static shapes, no data-dependent control flow — and the DM axis is chunked
  with lax.map to bound memory.
* boxcar S/N uses a cumulative-sum trick so all widths {1,2,...,boxcar_max}
  cost one pass.

Per-gulp halo: a valid search of gulp T needs max_delay extra samples of
lookahead; models/search.py overlaps gulps by that amount (the reference's
heimdall does the same internally with its gulp overlap).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from vlite_fast import constants as C


# ---------------------------------------------------------------------------
# DM grid and delay tables (host-side, numpy)
# ---------------------------------------------------------------------------

def dm_grid(dm_min: float, dm_max: float, ndm: int) -> np.ndarray:
    """Linear DM trial grid (heimdall's adaptive grid collapses to ~linear
    at VLITE's low frequency / coarse tsamp)."""
    return np.linspace(dm_min, dm_max, ndm, dtype=np.float64)


def dm_grid_tol(dm_min: float, dm_max: float, tsamp: float,
                freqs_mhz: np.ndarray, tol: float = 1.25,
                pulse_width_s: float = 0.0) -> np.ndarray:
    """Adaptive DM grid with bounded S/N loss (the dedisp/heimdall -dm_tol
    scheme): step so that the extra smearing from a half-step DM error
    keeps the effective width within `tol` of matched.

    smear(dDM) = K * dDM * (f_lo^-2 - f_hi^-2); step chosen with
    dDM = 2*sqrt(tol^2 - 1)*sqrt(tsamp^2 + w^2 + smear_chan^2)/sweep_rate.
    """
    if tol <= 1.0:
        raise ValueError(f"dm_tol must be > 1 (an S/N-loss FACTOR; "
                         f"got {tol}): tol=1 means zero allowed loss, "
                         "i.e. an infinitely fine grid")
    f = np.asarray(freqs_mhz, np.float64)
    sweep = C.DM_CONST_S * (f.min() ** -2.0 - f.max() ** -2.0)  # s per DM
    nchan = len(f)
    chan_sweep = sweep / nchan          # in-channel smearing per DM
    dms = [dm_min]
    while dms[-1] < dm_max:
        dm = dms[-1]
        weff2 = tsamp ** 2 + pulse_width_s ** 2 + (dm * chan_sweep) ** 2
        step = 2.0 * np.sqrt((tol * tol - 1.0) * weff2) / sweep
        dms.append(dm + step)
    return np.asarray(dms, np.float64)


def delay_table(dms: np.ndarray, freqs_mhz: np.ndarray,
                tsamp: float) -> np.ndarray:
    """(ndm, nchan) int32 delays in samples relative to the highest
    frequency in `freqs_mhz` (channel 0 in VLITE ordering)."""
    fref = float(np.max(freqs_mhz))
    d = C.DM_CONST_S * dms[:, None] * (freqs_mhz[None, :] ** -2.0 - fref ** -2.0)
    return np.round(d / tsamp).astype(np.int32)


# ---------------------------------------------------------------------------
# Subband two-stage dedispersion
# ---------------------------------------------------------------------------

@jax.tree_util.register_pytree_node_class
class DedispPlan:
    """Precomputed plan: index tables are device arrays (pytree children);
    geometry scalars are static aux data so jitted consumers can use them
    for shapes.  Built once per (geometry, DM grid); reused every gulp.
    """

    def __init__(self, rel_delays, sub_delays, batch_of_dm, chan_weights,
                 dms: tuple, max_delay: int, max_sub_delay: int,
                 nsub: int, nchan_eff: float, rel_delays_max: int = 0):
        self.rel_delays = rel_delays      # (nbatch, nchan) int32 in-subband
        self.sub_delays = sub_delays      # (ndm, nsub) int32 subband refs
        self.batch_of_dm = batch_of_dm    # (ndm,) int32 stage-1 batch index
        self.chan_weights = chan_weights  # (nchan,) 0/1 zap mask
        self.dms = dms                    # tuple of DM trial values (static)
        self.max_delay = max_delay        # halo width (static)
        self.max_sub_delay = max_sub_delay
        self.nsub = nsub
        self.nchan_eff = nchan_eff
        self.rel_delays_max = rel_delays_max

    def tree_flatten(self):
        return ((self.rel_delays, self.sub_delays, self.batch_of_dm,
                 self.chan_weights),
                (self.dms, self.max_delay, self.max_sub_delay, self.nsub,
                 self.nchan_eff, self.rel_delays_max))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    @property
    def dm_values(self) -> np.ndarray:
        return np.asarray(self.dms)

    def effective_delays(self) -> np.ndarray:
        """(ndm, nchan) delays the two-stage decomposition applies: each
        trial's subband reference delay plus its DM batch's in-subband
        delay — the table dedisperse_reference needs to reproduce the
        engines exactly."""
        sub = np.asarray(self.sub_delays)
        rel = np.asarray(self.rel_delays)[np.asarray(self.batch_of_dm)]
        return np.repeat(sub, rel.shape[1] // self.nsub, axis=1) + rel


def make_plan(dms: np.ndarray, freqs_mhz: np.ndarray, tsamp: float,
              nsub: int = 128, nbatch: int = 128,
              zap_ranges: Sequence[tuple] = ()) -> DedispPlan:
    nchan = len(freqs_mhz)
    ndm = len(dms)
    nbatch = min(nbatch, ndm)
    while ndm % nbatch:      # uniform batches (required by the Fourier path)
        nbatch -= 1
    if nchan % nsub:
        # shrink nsub to a divisor of nchan
        while nchan % nsub:
            nsub -= 1
    full = delay_table(np.asarray(dms), np.asarray(freqs_mhz), tsamp)
    # subband reference = first (highest-frequency) channel of each subband
    w = nchan // nsub
    ref_idx = np.arange(nsub) * w
    sub_delays = full[:, ref_idx]                       # (ndm, nsub)
    # stage-1 batches: representative DM per batch of contiguous trials
    edges = np.linspace(0, ndm, nbatch + 1).astype(int)
    batch_of_dm = np.zeros(ndm, dtype=np.int32)
    rep = np.zeros(nbatch, dtype=int)
    for b in range(nbatch):
        batch_of_dm[edges[b]:edges[b + 1]] = b
        rep[b] = (edges[b] + edges[b + 1] - 1) // 2
    rel = full[rep] - np.repeat(sub_delays[rep], w, axis=1)  # (nbatch, nchan)
    mask = np.ones(nchan, dtype=np.float32)
    for lo, hi in zap_ranges:
        mask[lo:hi] = 0.0
    return DedispPlan(
        rel_delays=jnp.asarray(rel),
        sub_delays=jnp.asarray(sub_delays),
        batch_of_dm=jnp.asarray(batch_of_dm),
        chan_weights=jnp.asarray(mask),
        dms=tuple(float(d) for d in dms),
        max_delay=int(full.max()),
        max_sub_delay=int(sub_delays.max()),
        nsub=nsub,
        nchan_eff=float(mask.sum()),
        rel_delays_max=int(rel.max()) if rel.size else 0,
    )


@partial(jax.jit, static_argnames=("ntime_out", "dm_chunk"))
def dedisperse(fb: jax.Array, plan: DedispPlan, ntime_out: int,
               dm_chunk: int = 16) -> jax.Array:
    """fb: (ntime, nchan) float32 (ntime >= ntime_out + plan.max_delay)
    -> (ndm, ntime_out) DM-time plane (channel-summed, zapped channels
    excluded)."""
    ntime, nchan = fb.shape
    nsub = plan.nsub
    w = nchan // nsub
    fbz = fb * plan.chan_weights[None, :]
    # stage-1 output must extend past ntime_out by the largest subband
    # delay, so stage 2 never reads past the intermediate buffer
    t1_len = ntime_out + plan.max_sub_delay
    t1 = jnp.arange(t1_len, dtype=jnp.int32)
    t = jnp.arange(ntime_out, dtype=jnp.int32)

    # ---- stage 1: within-subband dedispersion per DM batch ---------------
    # y[b, t, s] = sum_{ch in s} fb[t + rel[b, ch], ch]
    def stage1_batch(rel_b):
        idx = jnp.clip(t1[:, None] + rel_b[None, :], 0, ntime - 1)
        g = jnp.take_along_axis(fbz, idx, axis=0)        # (t1_len, nchan)
        return jnp.sum(g.reshape(t1_len, nsub, w), axis=-1)

    y = jax.lax.map(stage1_batch, plan.rel_delays,
                    batch_size=1)                        # (nbatch, t1, nsub)

    # ---- stage 2: combine subbands at full DM resolution -----------------
    def stage2_chunk(args):
        sub_d, batch_idx = args                          # (c, nsub), (c,)
        yb = y[batch_idx]                                # (c, t1, nsub)
        idx = t[None, :, None] + sub_d[:, None, :]       # within t1_len
        g = jnp.take_along_axis(yb, idx, axis=1)         # (c, T, nsub)
        return jnp.sum(g, axis=-1)

    ndm = plan.sub_delays.shape[0]
    nchunk = -(-ndm // dm_chunk)
    pad = nchunk * dm_chunk - ndm
    sub_d = jnp.pad(plan.sub_delays, ((0, pad), (0, 0)))
    b_idx = jnp.pad(plan.batch_of_dm, (0, pad))
    sub_d = sub_d.reshape(nchunk, dm_chunk, nsub)
    b_idx = b_idx.reshape(nchunk, dm_chunk)
    out = jax.lax.map(stage2_chunk, (sub_d, b_idx))      # (nchunk, c, T)
    return out.reshape(nchunk * dm_chunk, ntime_out)[:ndm]


@partial(jax.jit, static_argnames=("ntime_out", "batch_chunk",
                                   "phase_table"))
def dedisperse_fourier(fb: jax.Array, plan: DedispPlan, ntime_out: int,
                       batch_chunk: int = 8,
                       phase_table: bool = False) -> jax.Array:
    """Gather-free dedispersion: time shifts as Fourier phase ramps.

    A shift by integer d is exact in the DFT domain:
    ifft(X(f) * e^{+2*pi*i*f*d/N})[t] = x[t+d mod N]; zero-padding past the
    halo keeps the circular wrap out of the valid region.  Both subband
    stages become dense elementwise multiply-reduce over channels — FFTs,
    broadcasts and reductions only, no gathered reads (see dedisperse()
    for the time-domain variant).

    fb: (ntime, nchan) with ntime >= ntime_out + plan.max_delay.
    Returns (ndm, ntime_out).
    """
    ntime, nchan = fb.shape
    nsub = plan.nsub
    w = nchan // nsub
    npad = 1 << max(4, int(np.ceil(np.log2(ntime))))
    fbz = fb * plan.chan_weights[None, :]
    X = jnp.fft.rfft(fbz, n=npad, axis=0)            # (F, nchan)
    nfreq = X.shape[0]
    f = jnp.arange(nfreq, dtype=jnp.float32)
    omega = (2.0 * np.pi / npad) * f                 # (F,)

    nbatch = plan.rel_delays.shape[0]
    ndm = plan.sub_delays.shape[0]
    # group the DM trials by their stage-1 batch so each batch's subband
    # spectra are built once (trials per batch is uniform by construction)
    per_batch = ndm // nbatch

    # stage 1 needs nbatch*nchan*F phase factors (~1.7e10/gulp at
    # production scale).  A (max_rel+1, F) table + row gather avoids the
    # transcendentals but materializes the (F, nchan) factor block (4 GB
    # per chunk of 8) where exp() fuses into the multiply-reduce — so the
    # exp path is the default and the table an option.
    if phase_table:
        rr = jnp.arange(int(max(plan.rel_delays_max, 1)) + 1,
                        dtype=jnp.float32)
        theta_t = omega[None, :] * rr[:, None]
        table = jax.lax.complex(jnp.cos(theta_t), jnp.sin(theta_t))

    def one_batch(args):
        rel_b, sub_b = args          # (chunk, nchan), (chunk*per_batch, nsub)
        if phase_table:
            E = jnp.take(table, rel_b, axis=0)   # (chunk, nchan, F) rows
            E = jnp.swapaxes(E, 1, 2)            # (chunk, F, nchan)
        else:
            theta = omega[None, :, None] * rel_b[:, None, :].astype(
                jnp.float32)
            E = jax.lax.complex(jnp.cos(theta), jnp.sin(theta))
        # y_hat[c, f, s] = sum_w X[f, s*w+w'] * E[c, f, s*w+w']
        y = (X[None, :, :] * E).reshape(rel_b.shape[0], nfreq, nsub, w)
        y_hat = jnp.sum(y, axis=-1)                  # (chunk, F, nsub)
        # stage 2 for this batch's trials
        sub_b = sub_b.reshape(rel_b.shape[0], per_batch, nsub)
        theta2 = omega[None, None, :, None] * sub_b[:, :, None, :].astype(
            jnp.float32)
        E2 = jax.lax.complex(jnp.cos(theta2), jnp.sin(theta2))
        out_hat = jnp.sum(y_hat[:, None, :, :] * E2, axis=-1)
        return out_hat                               # (chunk, per_batch, F)

    batch_chunk = min(batch_chunk, nbatch)
    nchunk = -(-nbatch // batch_chunk)
    padb = nchunk * batch_chunk - nbatch
    rel = jnp.pad(plan.rel_delays, ((0, padb), (0, 0)))
    sub = jnp.pad(plan.sub_delays, ((0, padb * per_batch), (0, 0)))
    rel = rel.reshape(nchunk, batch_chunk, nchan)
    sub = sub.reshape(nchunk, batch_chunk * per_batch, nsub)
    out_hat = jax.lax.map(one_batch, (rel, sub))
    out_hat = out_hat.reshape((nbatch + padb) * per_batch, nfreq)[:ndm]
    out = jnp.fft.irfft(out_hat, n=npad, axis=-1)
    return out[:, :ntime_out]


def dedisperse_reference(fb: np.ndarray, delays: np.ndarray,
                         ntime_out: int,
                         chan_weights: np.ndarray | None = None) -> np.ndarray:
    """Direct (exact) numpy shift-and-sum oracle for tests."""
    ntime, nchan = fb.shape
    if chan_weights is not None:
        fb = fb * chan_weights[None, :]
    out = np.zeros((delays.shape[0], ntime_out), dtype=np.float64)
    for idm in range(delays.shape[0]):
        for ch in range(nchan):
            d = min(int(delays[idm, ch]), ntime - ntime_out)
            out[idm] += fb[d:d + ntime_out, ch]
    return out.astype(np.float32)


# ---------------------------------------------------------------------------
# Boxcar matched filter
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("widths", "noise", "noise_subsample"))
def boxcar_snr(dmt: jax.Array, nchan_eff: float,
               widths: tuple = (1, 2, 4, 8, 16, 32, 64),
               noise: str = "measured",
               noise_subsample: int = 8192) -> jax.Array:
    """Matched-filter S/N over boxcar widths.

    dmt: (ndm, ntime) channel-summed DM-time plane.  Baseline (per-DM
    mean) is subtracted; output (nwidth, ndm, ntime) with box ends aligned
    to t (the boxcar covering [t-w+1, t]).

    noise: 'measured' estimates each trial's noise robustly
    (1.4826 * median |deviation|, outlier-immune — the role of heimdall's
    per-trial baseline/normalization stage) so quantization scale and
    bandpass residuals don't bias S/N; 'expected' assumes unit-variance
    channels (sigma = sqrt(nchan_eff)).

    noise_subsample: the median is a full sort; estimating it from
    ~noise_subsample strided samples per trial (exact when ntime is
    already that small — all test geometries) sorts a third of the
    production gulp's samples.  Checked against
    the exact sort at production geometry (tests/test_noise_estimate
    .py, 1024 trials x 30720 samples): stride-3 (10240 samples) gives
    per-trial sigma jitter ~1.0% RMS, worst-of-1024-trials ~2.8% —
    a 6.0 threshold wobbles by under 0.2 S/N on the unluckiest trial
    (2048 strided samples measured 2.5% RMS / 8.5% worst: too loose).
    0 = exact.
    """
    ndm, ntime = dmt.shape
    base = jnp.mean(dmt, axis=1, keepdims=True)
    x = dmt - base
    if noise == "measured":
        step = max(1, ntime // noise_subsample) if noise_subsample else 1
        sigma = 1.4826 * jnp.median(jnp.abs(x[:, ::step]), axis=1)
        sigma = jnp.maximum(sigma, 1e-6)
    else:
        sigma = jnp.full((ndm,), jnp.sqrt(jnp.float32(nchan_eff)))
    cs = jnp.cumsum(x, axis=1)
    cs = jnp.concatenate([jnp.zeros((ndm, 1), dtype=cs.dtype), cs], axis=1)
    outs = []
    inv_sigma = (1.0 / sigma)[:, None]
    for w_ in widths:
        box = cs[:, w_:] - cs[:, :-w_]                   # (ndm, ntime-w+1)
        pad = jnp.zeros((ndm, w_ - 1), dtype=box.dtype)
        box = jnp.concatenate([pad, box], axis=1)
        outs.append(box * inv_sigma * jax.lax.rsqrt(jnp.float32(w_)))
    return jnp.stack(outs, axis=0)


# ---------------------------------------------------------------------------
# Candidate extraction (host-side; the output of one gulp is small)
# ---------------------------------------------------------------------------

class Candidate(NamedTuple):
    """One single-pulse candidate, field-compatible with a heimdall
    candidate line (ref src/candidate.py:3-24: snr, peak_idx, peak_time,
    tfilt, dmi, dm, ngiant, i0, i1)."""

    snr: float
    peak_idx: int        # sample index of peak (gulp-absolute)
    peak_time: float     # seconds from gulp start
    tfilt: int           # log2 boxcar width
    dmi: int             # DM trial index
    dm: float
    ngiant: int          # number of raw threshold crossings merged
    i0: int              # start sample
    i1: int              # end sample

    def to_line(self) -> str:
        return (f"{self.snr:.2f}\t{self.peak_idx}\t{self.peak_time:.4f}\t"
                f"{self.tfilt}\t{self.dmi}\t{self.dm:.3f}\t{self.ngiant}\t"
                f"{self.i0}\t{self.i1}")

    @classmethod
    def from_line(cls, line: str) -> "Candidate":
        f = line.split()
        return cls(float(f[0]), int(f[1]), float(f[2]), int(f[3]),
                   int(f[4]), float(f[5]), int(f[6]), int(f[7]), int(f[8]))


class _UnionFind:
    def __init__(self, n: int):
        self.parent = np.arange(n)

    def find(self, i: int) -> int:
        p = self.parent
        root = i
        while p[root] != root:
            root = p[root]
        while p[i] != root:          # path compression
            p[i], i = root, p[i]
        return root

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def find_candidates(snr: np.ndarray, dms: np.ndarray, tsamp: float,
                    thresh: float = 6.0,
                    widths: Sequence[int] = (1, 2, 4, 8, 16, 32, 64),
                    t_offset: int = 0,
                    max_cands: int = 4096,
                    dm_link: int = 4,
                    time_gap: int = 2) -> list:
    """Threshold + friends-of-friends cluster the (nwidth, ndm, ntime)
    S/N cube (heimdall's giant-finding/clustering stage).
    """
    snr = np.asarray(snr)
    hits = np.argwhere(snr > thresh)
    if hits.size == 0:
        return []
    vals = snr[hits[:, 0], hits[:, 1], hits[:, 2]]
    # cap: an RFI storm can produce millions of crossings; keep the
    # strongest (preserves every real event's peak and its neighborhood)
    cap = min(16 * max_cands, 20000)
    if len(vals) > cap:
        keep = np.argsort(-vals)[:cap]
        hits, vals = hits[keep], vals[keep]
    return cluster_hits(hits, vals, dms, tsamp, widths=widths,
                        t_offset=t_offset, max_cands=max_cands,
                        dm_link=dm_link, time_gap=time_gap)


def cluster_hits(hits: np.ndarray, vals: np.ndarray, dms: np.ndarray,
                 tsamp: float,
                 widths: Sequence[int] = (1, 2, 4, 8, 16, 32, 64),
                 t_offset: int = 0,
                 max_cands: int = 4096,
                 dm_link: int = 4,
                 time_gap: int = 2) -> list:
    """Friends-of-friends clustering of threshold crossings.

    hits: (n, 3) [width_idx, dm_idx, t_end] crossings (e.g. from a
    device-side top-k — the search ships ~20k crossings off-device, never
    the full S/N cube); vals: their S/N.

    Two crossings are friends when their boxcar time intervals overlap
    (allowing a `time_gap`-sample slack) AND their DM trials are within
    `dm_link` of each other; clusters are the transitive closure (a real
    pulse lights a contiguous (DM, width, time) blob, which chains into
    ONE cluster, while pulses separated in time or DM stay distinct —
    unlike round-1's greedy merge whose wide DM window glued neighbors).
    Each cluster yields one Candidate at its S/N peak; ngiant = cluster
    size, i0/i1 = cluster envelope.
    """
    hits = np.asarray(hits)
    vals = np.asarray(vals)
    if hits.size == 0:
        return []
    n = len(vals)
    w_arr = np.asarray(widths)[hits[:, 0]]
    lo = hits[:, 2] - w_arr + 1                    # interval [lo, hi)
    hi = hits[:, 2] + 1
    dmi = hits[:, 1]

    # Link DM trials d and d+delta (delta <= dm_link) with one sweep-line
    # pass over their merged lo-sorted hit lists.  Within such a pair
    # EVERY hit pair already satisfies the DM cut, so time-overlap runs
    # (lo[i] < max-hi-of-run + time_gap) give the exact transitive
    # closure of the pairwise predicate with O(n * dm_link) union calls —
    # a dense blob (one pulse lighting 20k crossings) clusters in ~0.1 s
    # where the previous per-pair check was quadratic (~1 min).
    uf = _UnionFind(n)
    order = np.argsort(lo, kind="stable")
    by_trial: dict = {}
    for idx in order:
        by_trial.setdefault(int(dmi[idx]), []).append(int(idx))
    for d, members in by_trial.items():
        for delta in range(0, dm_link + 1):
            other = by_trial.get(d + delta)
            if other is None or (delta == 0 and len(members) < 2):
                continue
            merged = members if delta == 0 else sorted(
                members + other, key=lambda i: lo[i])
            run_rep, run_hi = merged[0], hi[merged[0]]
            for i in merged[1:]:
                if lo[i] < run_hi + time_gap:
                    uf.union(run_rep, i)
                    if hi[i] > run_hi:
                        run_hi = int(hi[i])
                else:
                    run_rep, run_hi = i, int(hi[i])

    clusters: dict = {}
    for i in range(n):
        clusters.setdefault(uf.find(i), []).append(i)
    cands: list[Candidate] = []
    for members in clusters.values():
        m = np.asarray(members)
        k = m[np.argmax(vals[m])]
        iw, idm, it = hits[k]
        cands.append(Candidate(
            snr=float(vals[k]), peak_idx=int(it) + t_offset,
            peak_time=(int(it) + t_offset) * tsamp,
            tfilt=int(np.log2(widths[iw])), dmi=int(idm),
            dm=float(dms[idm]), ngiant=len(members),
            i0=int(lo[m].min()) + t_offset, i1=int(hi[m].max()) + t_offset))
    cands.sort(key=lambda c: -c.snr)
    return cands[:max_cands]
