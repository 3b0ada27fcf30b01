"""Dedispersion engine tests vs the exact numpy oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vlite_fast.config import SearchConfig
from vlite_fast.ops import dedisperse as dd


def make_fb(ntime=800, nchan=64, dm=150.0, t0=100, amp=5.0, seed=0,
            tsamp=2e-3):
    """Unit-variance noise + a dispersed pulse of per-channel amp."""
    rng = np.random.default_rng(seed)
    fb = rng.standard_normal((ntime, nchan)).astype(np.float32)
    freqs = 384.0 - np.arange(nchan) * (4.0 / nchan)  # 4 MHz band
    delays = dd.delay_table(np.array([dm]), freqs, tsamp)[0]
    for ch in range(nchan):
        t = t0 + delays[ch]
        if t < ntime:
            fb[t, ch] += amp
    return fb, freqs, delays


def test_delay_table_monotonic():
    freqs = 384.0 - np.arange(16) * 4.0
    d = dd.delay_table(np.array([10.0, 100.0]), freqs, 1e-3)
    assert d[0, 0] == 0
    assert np.all(np.diff(d[1]) >= 0)       # lower freq -> larger delay
    assert np.all(d[1] >= d[0])


def test_delay_table_absolute_value():
    # hand-computed cold-plasma delay (an INDEPENDENT oracle: every other
    # dedispersion test shares dd.delay_table on both sides, so a wrong
    # DM constant or scale would be invisible to them):
    # dt = 4148.808 * DM * (f_lo^-2 - f_hi^-2) seconds, f in MHz
    d = dd.delay_table(np.array([100.0]), np.array([384.0, 324.0]), 1e-3)
    expect = 4148.808 * 100.0 * (324.0 ** -2 - 384.0 ** -2)  # seconds
    assert d[0, 0] == 0
    assert d[0, 1] == round(expect / 1e-3)    # = 1139 samples at 1 ms
    # independent cross-check in GHz units (4.15 ms * DM * f_GHz^-2 form)
    expect_ghz = 4.15e-3 * 100.0 * (0.324 ** -2 - 0.384 ** -2)
    assert abs(expect - expect_ghz) < 0.002 * expect


def test_exact_plan_matches_oracle():
    fb, freqs, _ = make_fb()
    dms = dd.dm_grid(0, 300, 32)
    # exact mode: nbatch = ndm -> no within-subband approximation
    plan = dd.make_plan(dms, freqs, 2e-3, nsub=16, nbatch=32)
    ntime_out = fb.shape[0] - plan.max_delay
    out = np.asarray(dd.dedisperse(jnp.asarray(fb), plan, ntime_out,
                                   dm_chunk=8))
    full = dd.delay_table(dms, freqs, 2e-3)
    ref = dd.dedisperse_reference(fb, full, ntime_out)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-3)


def test_fourier_matches_oracle():
    fb, freqs, _ = make_fb()
    dms = dd.dm_grid(0, 300, 32)
    plan = dd.make_plan(dms, freqs, 2e-3, nsub=16, nbatch=32)
    ntime_out = fb.shape[0] - plan.max_delay
    out = np.asarray(dd.dedisperse_fourier(jnp.asarray(fb), plan, ntime_out,
                                           batch_chunk=8))
    full = dd.delay_table(dms, freqs, 2e-3)
    ref = dd.dedisperse_reference(fb, full, ntime_out)
    np.testing.assert_allclose(out, ref, rtol=2e-3, atol=2e-2)


def test_fourier_matches_subband():
    fb, freqs, _ = make_fb(ntime=600, nchan=32)
    dms = dd.dm_grid(0, 300, 64)
    plan = dd.make_plan(dms, freqs, 2e-3, nsub=8, nbatch=16)
    ntime_out = fb.shape[0] - plan.max_delay
    a = np.asarray(dd.dedisperse(jnp.asarray(fb), plan, ntime_out,
                                 dm_chunk=8))
    b = np.asarray(dd.dedisperse_fourier(jnp.asarray(fb), plan, ntime_out,
                                         batch_chunk=8))
    np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-2)


def test_subband_approx_close():
    fb, freqs, _ = make_fb()
    dms = dd.dm_grid(0, 300, 64)
    plan_x = dd.make_plan(dms, freqs, 2e-3, nsub=16, nbatch=64)
    plan_a = dd.make_plan(dms, freqs, 2e-3, nsub=16, nbatch=16)
    ntime_out = fb.shape[0] - max(plan_x.max_delay, plan_a.max_delay)
    ox = np.asarray(dd.dedisperse(jnp.asarray(fb), plan_x, ntime_out,
                                  dm_chunk=8))
    oa = np.asarray(dd.dedisperse(jnp.asarray(fb), plan_a, ntime_out,
                                  dm_chunk=8))
    # approximate within-subband delays smear the peak by at most ~1 sample
    # worth of per-channel misalignment; the peak must survive nearby
    ix = np.unravel_index(np.argmax(ox), ox.shape)
    ia = np.unravel_index(np.argmax(oa), oa.shape)
    assert abs(ix[0] - ia[0]) <= 4 and abs(ix[1] - ia[1]) <= 2
    assert oa.max() > 0.6 * ox.max()


def test_pulse_peaks_at_true_dm():
    dm_true = 150.0
    fb, freqs, _ = make_fb(dm=dm_true, amp=3.0)
    dms = dd.dm_grid(0, 300, 61)
    plan = dd.make_plan(dms, freqs, 2e-3, nsub=16, nbatch=61)
    ntime_out = fb.shape[0] - plan.max_delay
    dmt = np.asarray(dd.dedisperse(jnp.asarray(fb), plan, ntime_out))
    idm, it = np.unravel_index(np.argmax(dmt), dmt.shape)
    assert abs(dms[idm] - dm_true) <= 10.0
    assert abs(it - 100) <= 2


def test_boxcar_snr_oracle():
    rng = np.random.default_rng(1)
    ndm, ntime, nchan_eff = 4, 256, 64.0
    dmt = rng.standard_normal((ndm, ntime)).astype(np.float32) * np.sqrt(
        nchan_eff)
    # a width-8 square pulse on dm row 2
    dmt[2, 100:108] += 4.0 * np.sqrt(nchan_eff)
    snr = np.asarray(dd.boxcar_snr(jnp.asarray(dmt), nchan_eff,
                                   widths=(1, 2, 4, 8, 16)))
    assert snr.shape == (5, ndm, ntime)
    # width-8 filter maximizes S/N at the pulse end (t=107)
    iw, idm, it = np.unravel_index(np.argmax(snr), snr.shape)
    assert (iw, idm) == (3, 2)
    assert abs(it - 107) <= 1
    # matched-filter S/N ~ amp * sqrt(w) = 4*sqrt(8) ~ 11
    assert 8.0 < snr[3, 2, 107] < 15.0
    # FULL oracle: an independent numpy cumsum matched filter with the
    # same robust noise estimate (median |dev| * 1.4826)
    x = dmt - dmt.mean(axis=1, keepdims=True)
    sigma = np.maximum(1.4826 * np.median(np.abs(x), axis=1), 1e-6)
    cs = np.concatenate([np.zeros((ndm, 1)), np.cumsum(x, axis=1)], axis=1)
    for iw, w in enumerate((1, 2, 4, 8, 16)):
        box = cs[:, w:] - cs[:, :-w]
        ref = np.concatenate([np.zeros((ndm, w - 1)), box], axis=1) \
            / sigma[:, None] / np.sqrt(w)
        np.testing.assert_allclose(snr[iw], ref, rtol=2e-4, atol=2e-4)


def test_find_candidates():
    rng = np.random.default_rng(2)
    dmt = rng.standard_normal((16, 512)).astype(np.float32) * 8.0
    dmt[5, 200:204] += 10.0 * 8.0
    snr = np.asarray(dd.boxcar_snr(jnp.asarray(dmt), 64.0,
                                   widths=(1, 2, 4, 8)))
    dms = dd.dm_grid(0, 150, 16)
    cands = dd.find_candidates(snr, dms, 2e-3, thresh=6.0,
                               widths=(1, 2, 4, 8))
    assert len(cands) >= 1
    top = cands[0]
    assert top.dmi == 5
    assert 195 <= top.peak_idx <= 208
    assert top.snr > 10
    # candidate line round-trip (heimdall-compatible fields)
    c2 = dd.Candidate.from_line(top.to_line())
    assert c2.dmi == top.dmi and abs(c2.snr - top.snr) < 0.01


def test_zap_channels():
    fb, freqs, _ = make_fb()
    fb[:, 3] += 100.0  # hot channel
    dms = dd.dm_grid(0, 300, 16)
    plan = dd.make_plan(dms, freqs, 2e-3, nsub=16, nbatch=16,
                        zap_ranges=((0, 8),))
    assert plan.nchan_eff == fb.shape[1] - 8
    ntime_out = fb.shape[0] - plan.max_delay
    dmt = np.asarray(dd.dedisperse(jnp.asarray(fb), plan, ntime_out))
    # zapped hot channel must not dominate
    assert dmt.mean() < 10.0


def test_pallas_matches_oracle_exact():
    """Kernel in exact mode (nbatch=ndm) vs the numpy oracle, in the
    Pallas interpreter (the compiled kernel runs on the GPU)."""
    from vlite_fast.ops import dedisperse_pallas as ddp
    fb, freqs, _ = make_fb()
    dms = dd.dm_grid(0, 300, 32)
    plan = dd.make_plan(dms, freqs, 2e-3, nsub=16, nbatch=32)
    ntime_out = fb.shape[0] - plan.max_delay
    out = np.asarray(ddp.dedisperse_pallas(jnp.asarray(fb), plan,
                                           ntime_out, tile=128,
                                           interpret=True))
    full = dd.delay_table(dms, freqs, 2e-3)
    ref = dd.dedisperse_reference(fb, full, ntime_out)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-3)


def test_pallas_identical_to_subband_engine():
    """Approximate (nbatch < ndm) mode: the kernel computes the SAME
    two-stage decomposition as the gather engine, adding in the same
    order — bit-exact."""
    from vlite_fast.ops import dedisperse_pallas as ddp
    fb, freqs, _ = make_fb(ntime=600, nchan=32)
    dms = dd.dm_grid(0, 300, 64)
    plan = dd.make_plan(dms, freqs, 2e-3, nsub=8, nbatch=16)
    ntime_out = fb.shape[0] - plan.max_delay
    a = np.asarray(dd.dedisperse(jnp.asarray(fb), plan, ntime_out,
                                 dm_chunk=8))
    b = np.asarray(ddp.dedisperse_pallas(jnp.asarray(fb), plan, ntime_out,
                                         tile=64, interpret=True))
    np.testing.assert_array_equal(a, b)


def test_pallas_zap_channels():
    from vlite_fast.ops import dedisperse_pallas as ddp
    fb, freqs, _ = make_fb()
    fb[:, 3] += 100.0
    dms = dd.dm_grid(0, 300, 16)
    plan = dd.make_plan(dms, freqs, 2e-3, nsub=16, nbatch=16,
                        zap_ranges=((0, 8),))
    ntime_out = fb.shape[0] - plan.max_delay
    dmt = np.asarray(ddp.dedisperse_pallas(jnp.asarray(fb), plan,
                                           ntime_out, tile=128,
                                           interpret=True))
    assert dmt.mean() < 10.0


KERNEL_GEOMETRIES = {
    # name: (ntime, nchan, dm grid, nsub, nbatch, zap, tile)
    "linear": (800, 64, ("linear", 32), 16, 8, (), 128),
    "tol_grid": (900, 64, ("tol", 0), 16, 16, (), 128),
    "zapped": (800, 64, ("linear", 24), 16, 8, ((0, 8), (40, 48)), 128),
    "ragged_tile": (757, 32, ("linear", 16), 8, 4, (), 64),
    "nsub64": (700, 128, ("linear", 16), 64, 4, (), 256),
    "one_batch": (700, 64, ("linear", 24), 8, 1, (), 128),
}


@pytest.mark.parametrize("name", sorted(KERNEL_GEOMETRIES))
def test_pallas_kernel_geometries(name):
    """Interpret-mode kernel against the numpy oracle (applying the
    decomposition's own delays) and bit-exact to the XLA gather engine,
    across grids, zaps, tile raggedness, subband counts and batching."""
    from vlite_fast.ops import dedisperse_pallas as ddp
    ntime, nchan, (mode, ndm), nsub, nbatch, zap, tile = \
        KERNEL_GEOMETRIES[name]
    fb, freqs, _ = make_fb(ntime=ntime, nchan=nchan, amp=4.0)
    # multiples of 2^-6: every partial sum is exact in float32, so any
    # add order gives the same bits and the comparison tests the shifts
    # alone (XLA's CPU reduce adds 64 subbands in a vectorised tree;
    # test_pallas_identical_to_subband_engine checks the in-order case)
    fb = np.round(fb * 64.0).astype(np.float32) / np.float32(64.0)
    if mode == "tol":
        dms = dd.dm_grid_tol(0.0, 300.0, 2e-3, freqs, tol=1.25)
    else:
        dms = dd.dm_grid(0, 300, ndm)
    plan = dd.make_plan(dms, freqs, 2e-3, nsub=nsub, nbatch=nbatch,
                        zap_ranges=zap)
    eff = plan.effective_delays()
    ntime_out = ntime - max(plan.max_delay, int(eff.max()))
    assert ntime_out % tile              # a partial last tile
    out = np.asarray(ddp.dedisperse_pallas(jnp.asarray(fb), plan,
                                           ntime_out, tile=tile,
                                           interpret=True))
    assert out.shape == (len(dms), ntime_out)
    xla = np.asarray(dd.dedisperse(jnp.asarray(fb), plan, ntime_out,
                                   dm_chunk=8))
    np.testing.assert_array_equal(out, xla)
    ref = dd.dedisperse_reference(fb, eff, ntime_out,
                                  chan_weights=np.asarray(
                                      plan.chan_weights))
    np.testing.assert_array_equal(out, ref)


def test_pallas_tile_must_be_power_of_two():
    from vlite_fast.ops import dedisperse_pallas as ddp
    fb, freqs, _ = make_fb(ntime=400, nchan=16)
    plan = dd.make_plan(dd.dm_grid(0, 100, 8), freqs, 2e-3, nsub=4,
                        nbatch=4)
    with pytest.raises(ValueError, match="power of two"):
        ddp.dedisperse_pallas(jnp.asarray(fb), plan, 100, tile=96,
                              interpret=True)


def test_pallas_kernel_lowers_through_triton():
    """The wrapper's kernels lower to Triton for CUDA without a card
    (what interpret mode cannot show: an op the Triton route refuses).
    Compiling that IR to PTX happens only on the card."""
    from jax import export
    from vlite_fast.ops import dedisperse_pallas as ddp
    freqs = 384.0 - np.arange(256) * (4.0 / 256)
    plan = dd.make_plan(dd.dm_grid(0, 300, 64), freqs, 2e-3, nsub=16,
                        nbatch=16)
    ntime = 2048 + plan.max_delay
    fn = jax.jit(lambda fb, p: ddp.dedisperse_pallas(fb, p, 2048))
    exp = export.export(fn, platforms=["cuda"], disabled_checks=[
        export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")])(
        jax.ShapeDtypeStruct((ntime, 256), jnp.float32), plan)
    text = exp.mlir_module()
    assert text.count("__gpu$xla.gpu.triton") == 2
    assert 'name = "dedisp_stage1"' in text
    assert 'name = "dedisp_stage2"' in text


@pytest.mark.gpu
def test_pallas_kernel_compiled_matches_subband(gpu_device):
    """On the card: the compiled kernel against the XLA gather engine,
    bit-exact on multiples of 2^-6 (every partial sum exact in float32,
    so the engines' add orders cannot differ in the result)."""
    from vlite_fast.ops import dedisperse_pallas as ddp
    fb, freqs, _ = make_fb(ntime=3000, nchan=256, amp=4.0)
    fb = np.round(fb * 64.0).astype(np.float32) / np.float32(64.0)
    plan = dd.make_plan(dd.dm_grid(0, 300, 256), freqs, 2e-3, nsub=32,
                        nbatch=32)
    ntime_out = fb.shape[0] - plan.max_delay
    x = jax.device_put(fb, gpu_device)
    a = np.asarray(dd.dedisperse(x, plan, ntime_out))
    b = np.asarray(ddp.dedisperse_pallas(x, plan, ntime_out))
    np.testing.assert_array_equal(a, b)


def test_fof_one_pulse_one_candidate():
    """A single dispersed pulse lights a (DM, width, time) blob of
    crossings that must collapse to exactly ONE candidate."""
    fb, freqs, _ = make_fb(amp=6.0)
    dms = dd.dm_grid(0, 300, 61)
    plan = dd.make_plan(dms, freqs, 2e-3, nsub=16, nbatch=61)
    ntime_out = fb.shape[0] - plan.max_delay
    dmt = np.asarray(dd.dedisperse(jnp.asarray(fb), plan, ntime_out))
    snr = np.asarray(dd.boxcar_snr(jnp.asarray(dmt), plan.nchan_eff,
                                   widths=(1, 2, 4, 8)))
    cands = dd.find_candidates(snr, dms, 2e-3, thresh=6.5,
                               widths=(1, 2, 4, 8))
    strong = [c for c in cands if c.snr > 6.5]
    assert len(strong) == 1, [c.to_line() for c in strong]
    assert strong[0].ngiant > 3          # the blob was linked, not split


def test_fof_nearby_pulses_not_merged():
    """Two pulses ~60 samples apart at the same DM must yield two
    candidates (round-1's greedy merge glued such neighbors)."""
    rng = np.random.default_rng(5)
    ndm, ntime = 32, 800
    dmt = rng.standard_normal((ndm, ntime)).astype(np.float32) * 4.0
    for t0 in (300, 360):
        dmt[10:13, t0:t0 + 4] += 12.0 * 4.0
    snr = np.asarray(dd.boxcar_snr(jnp.asarray(dmt), 16.0,
                                   widths=(1, 2, 4, 8)))
    dms = dd.dm_grid(0, 150, ndm)
    cands = dd.find_candidates(snr, dms, 2e-3, thresh=7.0,
                               widths=(1, 2, 4, 8))
    peaks = sorted(c.peak_idx for c in cands if c.snr > 10)
    assert len(peaks) == 2, [c.to_line() for c in cands]
    assert abs(peaks[0] - 303) <= 4 and abs(peaks[1] - 363) <= 4


def test_fof_distant_dm_not_merged():
    """Simultaneous events at well-separated DMs stay separate."""
    rng = np.random.default_rng(6)
    ndm, ntime = 64, 400
    dmt = rng.standard_normal((ndm, ntime)).astype(np.float32) * 4.0
    dmt[5:8, 200:204] += 12.0 * 4.0
    dmt[50:53, 200:204] += 12.0 * 4.0
    snr = np.asarray(dd.boxcar_snr(jnp.asarray(dmt), 16.0,
                                   widths=(1, 2, 4)))
    dms = dd.dm_grid(0, 300, ndm)
    cands = [c for c in dd.find_candidates(snr, dms, 2e-3, thresh=7.0,
                                           widths=(1, 2, 4)) if c.snr > 10]
    assert len(cands) == 2
    assert {c.dmi < 20 for c in cands} == {True, False}


def test_tol_grid_default_and_recovery():
    """Production default: tolerance-driven DM trials (heimdall -dm_tol);
    a pulse is still recovered at its DM with the adaptive grid."""
    from vlite_fast.config import SearchConfig
    from vlite_fast.models import search as sm
    fb, freqs, _ = make_fb(amp=4.0)
    scfg = SearchConfig(dm_min=0.0, dm_max=300.0, gulp_samps=512,
                        boxcar_max=8, zap_ranges=(), snr_thresh=6.0)
    assert scfg.dm_grid_mode == "tol"
    eng = sm.SinglePulseSearch(scfg, 2e-3, freqs, nsub=16, nbatch=64)
    assert len(eng.dms) % 128 == 0        # padded for uniform DM batches
    # the underlying tolerance grid is adaptive: steps grow with DM
    raw = dd.dm_grid_tol(0.0, 300.0, 2e-3, freqs, tol=1.25)
    steps = np.diff(raw)
    assert steps[-1] > steps[0]
    cands = eng.search_stream(fb.astype(np.float32))
    best = max(cands, key=lambda c: c.snr)
    assert abs(best.dm - 150.0) < 20.0
