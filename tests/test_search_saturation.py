"""Top-k saturation under an RFI storm (VERDICT r2 weak #3).

The device->host return of a gulp search is a fixed-size top-k; an RFI
storm of bright broadband impulses produces far more threshold crossings
than k.  The per-DM-band quota (models/search.pack_topk_banded) confines
the storm to the bands its DM spread actually covers, so an injected
dispersed pulse at high DM still comes home, while the in-graph crossing
count and the saturated-band counter expose the overflow to metrics.
Reference analogue: heimdall's giant-cluster limits.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from vlite_fast.config import SearchConfig
from vlite_fast.models import search as search_mod
from vlite_fast.ops import dedisperse as dd


NCHAN = 64
TSAMP = 781.25e-6
FREQS = np.linspace(320.0, 360.0, NCHAN)
DM_PULSE = 50 * 100.0 / 63      # exactly on DM trial 50 (band 6 of 8):
                                # off-grid DM spreads the 2-sample pulse
                                # over the ~25-sample inter-trial smear
T0 = 1000
PULSE_AMP = 3.0
STORM_AMP = 15.0
# sparse enough that the robust per-trial noise estimate (mean baseline +
# median |dev|) is only mildly inflated — a denser storm desensitizes the
# whole gulp, which is its own (acceptable) protection
N_STORM = 60


def _scfg(**kw):
    base = dict(dm_min=0.0, dm_max=100.0, ndm=64, gulp_samps=2048,
                boxcar_max=8, zap_ranges=(), snr_thresh=6.0,
                max_candidates=128,   # clustering room for ~60 storm blobs
                topk=256,             # small device return -> kb=32/band
                engine="subband", dm_grid_mode="linear")
    base.update(kw)
    return SearchConfig(**base)


def _storm_gulp(engine, rng):
    """Noise + N_STORM broadband impulses (zero-DM RFI) + one dispersed
    pulse at DM_PULSE, shaped (gulp + overlap, nchan)."""
    ntime = engine.scfg.gulp_samps + engine.overlap
    fb = rng.standard_normal((ntime, NCHAN)).astype(np.float32)
    storm_t = rng.integers(0, ntime, N_STORM)
    fb[storm_t, :] += STORM_AMP
    delays = dd.delay_table(np.array([DM_PULSE]), FREQS, TSAMP)[0]
    for ch in range(NCHAN):
        t = T0 + int(delays[ch])
        fb[t:t + 2, ch] += PULSE_AMP
    return fb


@pytest.fixture(scope="module")
def runs():
    """Run the SAME storm gulp through the banded engine and through a
    single global band (the round-2 behavior)."""
    rng = np.random.default_rng(42)
    banded = search_mod.SinglePulseSearch(_scfg(), TSAMP, FREQS)
    fb = _storm_gulp(banded, rng)
    cands_banded = banded.search_gulp(fb.copy())
    global_eng = search_mod.SinglePulseSearch(
        _scfg(topk_dm_bands=1), TSAMP, FREQS)
    cands_global = global_eng.search_gulp(fb.copy())
    return dict(banded=banded, cands_banded=cands_banded,
                cands_global=cands_global, fb=fb)


def _pulse_hits(cands):
    return [c for c in cands
            if abs(c.dm - DM_PULSE) < 8.0 and abs(c.peak_idx - T0) < 16]


def test_storm_exceeds_k(runs):
    """Premise: the storm really does overflow the fixed-size return."""
    st = runs["banded"].last_gulp_stats
    k = runs["banded"].scfg.topk
    assert st["n_crossings"] > 2 * k, st


def test_saturation_detected_and_metered(runs):
    st = runs["banded"].last_gulp_stats
    assert st["saturated_bands"] >= 1, st
    # the storm is zero-DM: only the low-DM band(s) may saturate —
    # the quota must leave the high-DM bands open for real pulses
    assert st["saturated_bands"] <= 3, st


def test_pulse_survives_storm_with_banding(runs):
    """The injected DM-80 pulse still triggers through the 20k+-crossing
    storm (VERDICT 'done' criterion)."""
    hits = _pulse_hits(runs["cands_banded"])
    assert hits, [f"{c.dm:.1f}@{c.peak_idx}" for c in
                  runs["cands_banded"][:10]]
    assert max(c.snr for c in hits) > 8.0


def test_global_topk_would_lose_the_pulse(runs):
    """Documents the failure mode the quota exists for: with one global
    band, every return slot is taken by a storm crossing brighter than
    the pulse, and the pulse candidate never reaches the host."""
    assert not _pulse_hits(runs["cands_global"])


def test_quiet_gulp_not_saturated():
    """No storm -> no saturation, and the pulse is found as before.
    (k sized normally here — a very bright pulse can legitimately fill
    its own band's quota, which is not a failure.)"""
    rng = np.random.default_rng(3)
    eng = search_mod.SinglePulseSearch(_scfg(topk=1024), TSAMP, FREQS)
    ntime = eng.scfg.gulp_samps + eng.overlap
    fb = rng.standard_normal((ntime, NCHAN)).astype(np.float32)
    delays = dd.delay_table(np.array([DM_PULSE]), FREQS, TSAMP)[0]
    for ch in range(NCHAN):
        t = T0 + int(delays[ch])
        fb[t:t + 2, ch] += PULSE_AMP
    cands = eng.search_gulp(fb)
    assert _pulse_hits(cands)
    assert eng.last_gulp_stats["saturated_bands"] == 0


def test_full_band_return_never_saturated():
    """When kb covers a band's entire cube, every crossing was returned
    and nothing can have been dropped on device — even a cube that is
    all-above-threshold must not count as saturated (a false saturation
    would tell the operator to zap channels for no reason)."""
    nw, ndm, ntime = 2, 8, 10
    snr = jnp.full((nw, ndm, ntime), 50.0, jnp.float32)
    nbands = 4
    k = nw * ndm * ntime  # kb = whole band cube
    packed = search_mod.pack_topk_banded(snr, k, nbands, 6.0)
    vals, hits, n_cross, sat = search_mod.decode_crossings(
        np.asarray(packed), nw, ndm, ntime, nbands, 6.0)
    assert n_cross == nw * ndm * ntime
    assert len(vals) == nw * ndm * ntime
    assert sat == 0


def test_effective_nbands_single_definition():
    """Device packer and host decoder must share ONE divisibility
    fallback (review finding: four duplicated copies risked silent
    desync of the wire layout)."""
    assert search_mod.effective_nbands(1024, 8) == 8
    assert search_mod.effective_nbands(1000, 8) == 8
    assert search_mod.effective_nbands(1001, 8) == 1
    assert search_mod.effective_nbands(7, 0) == 1


def test_pack_decode_roundtrip_matches_exact_topk():
    """pack_topk_banded/decode_crossings invert each other and agree
    with an exact per-band numpy top-k on a random cube (CPU
    approx_max_k lowers to an exact sort)."""
    rng = np.random.default_rng(0)
    nw, ndm, ntime = 3, 16, 40
    snr = rng.standard_normal((nw, ndm, ntime)).astype(np.float32) * 2.0
    k, nbands, thresh = 32, 4, 2.5
    packed = np.asarray(search_mod.pack_topk_banded(
        jnp.asarray(snr), k, nbands, thresh))
    vals, hits, n_cross, sat = search_mod.decode_crossings(
        packed, nw, ndm, ntime, nbands, thresh)
    assert n_cross == int((snr > thresh).sum())
    # every decoded crossing points at its own S/N value
    for v, (w, dmi, t) in zip(vals, hits):
        assert snr[w, dmi, t] == v
        assert v > thresh
    # per band: the returned crossings are exactly the band's top values
    # above threshold (kb = 8 slots each)
    dmb = ndm // nbands
    for b in range(nbands):
        band = snr[:, b * dmb:(b + 1) * dmb, :].ravel()
        expect = np.sort(band[band > thresh])[::-1][:k // nbands]
        got = np.sort(vals[(hits[:, 1] >= b * dmb)
                           & (hits[:, 1] < (b + 1) * dmb)])[::-1]
        np.testing.assert_allclose(got, expect)
