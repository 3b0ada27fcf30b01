"""Offline analysis tests: dumps, correlation, delays, TDOA localization."""

import numpy as np
import pytest

from vlite_fast.analysis import baseband as bb
from vlite_fast.analysis import localization as loc
from vlite_fast.utils import vdif


RATE = 1_000_000


def make_dump(delay_samples=0, seed=0, nsec=1, station=1, t0=100.0,
              common=None):
    rng = np.random.default_rng(seed)
    n = RATE * nsec
    if common is None:
        common = rng.standard_normal(n + 1000).astype(np.float32)
    noise = 0.3 * rng.standard_normal((2, n)).astype(np.float32)
    x = np.stack([common[delay_samples:delay_samples + n]] * 2) + noise
    u = np.clip(x / 0.05914 + 128.5, 0, 255).astype(np.uint8)
    return bb.VoltageDump(samples=u, start_time=t0, station_id=station,
                          sample_rate=RATE), common


def test_voltage_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    nsamp = 5000 * 20
    samples = rng.integers(1, 255, (2, nsamp), dtype=np.uint8)
    stream = vdif.streams_to_frames(samples, ref_epoch=40, start_second=7,
                                    station_id=4, sample_rate=RATE)
    p = tmp_path / "dump.vdif"
    stream.tofile(p)
    d = bb.VoltageDump.from_file(str(p), sample_rate=RATE)
    np.testing.assert_array_equal(d.samples, samples)
    assert d.station_id == 4


def test_re_order():
    a, _ = make_dump(t0=100.0, seed=1)
    b, _ = make_dump(t0=100.25, seed=2)
    out = bb.re_order([a, b])
    assert out[0].start_time == out[1].start_time == 100.25
    assert out[0].nsamp == out[1].nsamp
    assert out[0].nsamp == int(0.75 * RATE)


def test_filterbank_tone():
    # a strong tone should appear in the right channel
    n = RATE // 2
    t = np.arange(n)
    tone = 2.0 * np.cos(2 * np.pi * 0.21 * t).astype(np.float32)
    rng = np.random.default_rng(3)
    x = tone + rng.standard_normal((2, n)).astype(np.float32)
    u = np.clip(x / 0.05914 + 128.5, 0, 255).astype(np.uint8)
    d = bb.VoltageDump(samples=u, start_time=0.0, station_id=1,
                       sample_rate=RATE)
    p = bb.filterbank(d, nfft=500)
    chan = int(round(0.21 * 500))
    prof = p.mean(axis=0)
    assert np.argmax(prof) == chan


def test_correlation_and_delay():
    common = None
    a, common = make_dump(delay_samples=0, seed=4, common=common)
    b, _ = make_dump(delay_samples=7, seed=5, common=common, station=2)
    delay, snr = bb.baseline_delay(a, b, nfft=500)
    # b's stream is the common signal ADVANCED by 7 samples (b earlier),
    # so tau_a - tau_b = +7 samples: the SIGN is part of the contract
    # (a double-abs here could not catch an inverted convention)
    assert abs(delay * RATE - 7.0) < 1.5
    assert snr > 10


def test_correlation_matrix_autos():
    a, c = make_dump(seed=6)
    b, _ = make_dump(seed=7, common=c, station=2)
    m = bb.correlation_matrix([a, b], nfft=500)
    assert m.shape[0] == m.shape[1] == 2
    # autos are real-positive; cross has high coherence
    assert np.all(np.abs(np.imag(m[0, 0])) < 1e-3 * np.abs(m[0, 0]).max())
    coh = np.abs(m[0, 1]).sum() / np.sqrt(
        np.abs(m[0, 0]).sum() * np.abs(m[1, 1]).sum())
    assert coh > 0.5


def test_tdoa_recovers_direction():
    rng = np.random.default_rng(8)
    nant = 6
    positions = rng.uniform(-1000, 1000, (nant, 3))
    positions[:, 2] = 0.0
    pairs = [(i, j) for i in range(nant) for j in range(i + 1, nant)]
    az_true, el_true = 1.1, 0.7
    s = loc.direction_unit(np.array(az_true), np.array(el_true))
    delays = loc.expected_delays(positions, pairs, s)
    delays = delays + rng.normal(0, 5e-9, delays.shape)
    fit = loc.fit_tdoa(positions, pairs, delays, sigma=10e-9)
    assert abs(fit.az - az_true) < 0.05
    assert abs(fit.el - el_true) < 0.05


def test_tdoa_clock_offsets():
    rng = np.random.default_rng(9)
    positions = rng.uniform(-500, 500, (4, 3))
    pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    s = loc.direction_unit(np.array(0.3), np.array(1.0))
    clocks = rng.normal(0, 1e-6, 4)
    delays = loc.expected_delays(positions, pairs, s) + np.array(
        [clocks[i] - clocks[j] for i, j in pairs])
    fit = loc.fit_tdoa(positions, pairs, delays, sigma=10e-9,
                       clock_offsets=clocks)
    assert abs(fit.az - 0.3) < 0.1 and abs(fit.el - 1.0) < 0.1


def test_fractional_shift():
    from vlite_fast.analysis.beamforming import fractional_shift
    import jax.numpy as jnp
    t = np.arange(512)
    x = np.sin(2 * np.pi * 10 * t / 512).astype(np.float32)
    y = np.asarray(fractional_shift(jnp.asarray(x), jnp.float32(3.0)))
    np.testing.assert_allclose(y[:-3], x[3:], atol=1e-4)
    # half-sample shift of a sine = phase-advanced sine
    y2 = np.asarray(fractional_shift(jnp.asarray(x), jnp.float32(0.5)))
    ref = np.sin(2 * np.pi * 10 * (t + 0.5) / 512)
    np.testing.assert_allclose(y2[10:-10], ref[10:-10], atol=1e-3)


def test_beamform_coherent_gain():
    from vlite_fast.analysis import beamforming as bf
    rng = np.random.default_rng(20)
    n = 200_000
    pulse = np.zeros(n, np.float32)
    # SHARP bursts (3 samples), narrower than every shift below: a
    # sign-inverted alignment (2*shift misalignment) then decorrelates —
    # a wide burst would still overlap itself and pass
    for i0 in range(100_000, 140_000, 1000):
        pulse[i0:i0 + 3] = 4.0
    common = pulse
    shifts = [0, 17, -9, 25]
    dumps = []
    for k, sh in enumerate(shifts):
        noise = rng.standard_normal((2, n)).astype(np.float32)
        sig = np.roll(common, -sh)   # antenna k sees burst sh samples early
        x = sig[None, :] + noise
        u = np.clip(x / 0.05914 + 128.5, 0, 255).astype(np.uint8)
        dumps.append(bb.VoltageDump(samples=u, start_time=50.0,
                                    station_id=k + 1, sample_rate=RATE))
    # delays_s[k] = how much EARLIER antenna k received (the documented
    # convention, now honored: beamform internally DELAYS each stream)
    delays = np.array(shifts) / RATE
    beam = bf.beamform(dumps, delays_s=delays)
    onidx = np.concatenate([np.arange(i0, i0 + 3)
                            for i0 in range(100_000, 140_000, 1000)])
    def burst_power(v):
        p = (v ** 2).mean(axis=0)
        return p[onidx].mean() - p[:50_000].mean()
    # coherent gain: signal power ~ N * single-antenna, noise stays ~1
    gain = burst_power(beam.voltages()) / burst_power(dumps[0].voltages())
    assert gain > 2.5   # ideal 4 antennas -> 4x power


def test_candidate_cutout():
    from vlite_fast.analysis import cutout
    from vlite_fast.ops.dedisperse import Candidate
    rng = np.random.default_rng(30)
    fb = rng.standard_normal((1000, 32)).astype(np.float32)
    freqs = 384.0 - np.arange(32) * 0.1
    c = Candidate(snr=10, peak_idx=500, peak_time=1.0, tfilt=2, dmi=3,
                  dm=50.0, ngiant=1, i0=495, i1=505)
    start, blk = cutout.candidate_block(fb, c, 2e-3, freqs, wmult=2)
    assert start < 495 and blk.shape[0] > 30
    sm = cutout.tophat(blk, 2)
    assert sm.shape == blk.shape
    assert sm.std() < blk.std()          # smoothing reduces variance
    prof = cutout.dedispersed_profile(blk, 50.0, 2e-3, freqs)
    assert np.isfinite(prof).all()


def test_localization_from_dumps():
    """Full offline localization slice (loc_step2+3 roles): plane-wave
    delayed impulses at 5 antennas -> per-baseline delays -> TDOA fit."""
    from vlite_fast.analysis import localization as loc
    rng = np.random.default_rng(31)
    nant, n = 5, 400_000
    positions = rng.uniform(-2000, 2000, (nant, 3))
    positions[:, 2] = 0.0
    az_true, el_true = 2.2, 0.9
    s_hat = loc.direction_unit(np.array(az_true), np.array(el_true))
    tau = positions @ s_hat / loc.C_LIGHT        # arrival offsets [s]
    # common broadband impulsive signal
    common = np.zeros(n + 4000, np.float32)
    impulses = rng.integers(2000, n, 50)
    common[impulses] = 20.0
    common += rng.standard_normal(n + 4000).astype(np.float32) * 0.3
    dumps = []
    for k in range(nant):
        # PHYSICAL encoding: an antenna with larger r.s_hat is closer to
        # the source and receives the wavefront EARLIER (features at
        # smaller sample indices)
        shift = int(round(tau[k] * RATE))
        sig = common[2000 + shift:2000 + shift + n]
        x = np.stack([sig, sig]) + rng.standard_normal((2, n)) * 0.5
        u = np.clip(x * 128 + 128.5, -0, 255).astype(np.uint8)
        dumps.append(bb.VoltageDump(samples=u, start_time=0.0,
                                    station_id=k + 1, sample_rate=RATE))
    pairs = [(i, j) for i in range(nant) for j in range(i + 1, nant)]
    delays = []
    for i, j in pairs:
        d, snr = bb.baseline_delay(dumps[i], dumps[j], nfft=500)
        delays.append(d)
    fit = loc.fit_tdoa(positions, pairs, np.array(delays),
                       sigma=2.0 / RATE)
    assert abs(fit.az - az_true) < 0.15
    assert abs(fit.el - el_true) < 0.15


def test_refine_dm():
    rng = np.random.default_rng(10)
    ntime, nchan = 600, 64
    fb = rng.standard_normal((ntime, nchan)).astype(np.float32)
    freqs = 384.0 - np.arange(nchan) * (4.0 / nchan)
    from vlite_fast.ops import dedisperse as dd
    true_dm = 150.0
    delays = dd.delay_table(np.array([true_dm]), freqs, 2e-3)[0]
    for ch in range(nchan):
        fb[100 + delays[ch], ch] += 4.0
    dm_grid = np.linspace(50, 250, 41)
    dm_best, snr = loc.refine_dm(fb, 2e-3, freqs, dm_grid)
    assert abs(dm_best - true_dm) < 15.0


def test_cyclic_autocorrelation_detects_modulation():
    """Cyclic spectrum via correlate(alpha_hz): an amplitude-modulated
    tone has a nonzero cyclic autocorrelation at its modulation rate,
    plain noise does not (ref analysis/baseband.py:811,842-846)."""
    rng = np.random.default_rng(20)
    n = 400_000
    t = np.arange(n)
    f0, fmod = 0.21, 0.004         # cycles/sample
    am = (1.0 + 0.9 * np.cos(2 * np.pi * fmod * t))
    sig = am * np.cos(2 * np.pi * f0 * t)
    x = sig + 0.5 * rng.standard_normal(n)
    u = np.clip(np.stack([x, x]) * 40 + 128.5, 0, 255).astype(np.uint8)
    d = bb.VoltageDump(samples=u, start_time=0.0, station_id=1,
                       sample_rate=RATE)
    nfft = 500
    alpha = 2 * fmod * RATE        # AM cyclic feature at 2*fmod
    cyc = bb.correlate(d, d, nfft=nfft, alpha_hz=alpha)[0, 0]
    base = bb.correlate(d, d, nfft=nfft, alpha_hz=10 * alpha)[0, 0]
    # the shift-by-2*fmod product links the AM sidebands f0 +- fmod
    chan = int(round((f0 + fmod) * nfft))
    assert np.abs(cyc[chan]) > 5 * np.abs(base[chan])
    # incommensurate cyclic frequency is rejected
    with pytest.raises(ValueError):
        bb.correlate(d, d, nfft=nfft, alpha_hz=RATE / nfft * 1.5)


def test_beamform_toward_true_direction_not_mirror():
    """beamform_toward(positions, az, el) must be coherent at the TRUE
    direction and decorrelated at the mirror (az+pi): the delay sign
    convention end-to-end (geometric_delays -> beamform alignment).
    Regression: an inverted alignment sign put the coherent peak at the
    mirror direction and below a single antenna at the true one."""
    from vlite_fast.analysis import beamforming as bf
    rng = np.random.default_rng(5)
    nant, n = 4, 200_000
    positions = rng.uniform(-6000, 6000, (nant, 3))
    positions[:, 2] = 0.0
    az_t, el_t = 2.2, 0.6
    s_hat = loc.direction_unit(np.array(az_t), np.array(el_t))
    tau = positions @ s_hat / loc.C_LIGHT
    common = np.zeros(n + 4000, np.float32)
    for i0 in range(100_000, 140_000, 1000):
        common[i0:i0 + 3] = 3.0             # sharp coherent bursts
    dumps = []
    for k in range(nant):
        sh = int(round(tau[k] * RATE))      # physical: closer = earlier
        sig = common[2000 + sh:2000 + sh + n]
        x = sig[None, :] + rng.standard_normal((2, n)).astype(np.float32)
        u = np.clip(x / 0.05914 + 128.5, 0, 255).astype(np.uint8)
        dumps.append(bb.VoltageDump(samples=u, start_time=0.0,
                                    station_id=k + 1, sample_rate=RATE))

    def snr(v):
        p = (v.astype(np.float64) ** 2).mean(axis=0)
        onidx = np.concatenate([np.arange(i0 - 2002, i0 - 1995)
                                for i0 in range(100_000, 140_000, 1000)])
        return (p[onidx].mean() - p[:50_000].mean()) / p[:50_000].mean()

    s_beam = snr(bf.beamform_toward(dumps, positions, az_t,
                                    el_t).voltages())
    s_single = snr(dumps[0].voltages())
    s_mirror = snr(bf.beamform_toward(dumps, positions, az_t + np.pi,
                                      el_t).voltages())
    assert s_beam > 2.5 * s_single > 0      # coherent gain at truth
    assert s_beam > 3 * s_mirror            # mirror decorrelates


# ---------------------------------------------------------------------------
# Celestial frame chain (loc_step3 end product)
# ---------------------------------------------------------------------------

def test_gmst_j2000_published_value():
    """GMST at the J2000.0 epoch (2000-01-01 12:00 UT) is 18h41m50.548s
    = 280.46062 deg (IAU 1982; Meeus)."""
    g = loc.gmst_rad(946_728_000.0)
    assert abs(np.degrees(g) - 280.46062) < 1e-3


def test_itrs_to_icrs_sidereal_period():
    """A vector fixed in ITRS returns to (almost) the same ICRS RA after
    one SIDEREAL day, but drifts ~0.9856 deg after one SOLAR day."""
    t0 = 1.7e9
    v = np.array([1.0, 0.3, 0.2])
    v /= np.linalg.norm(v)

    def ra_of(t):
        w = loc.itrs_to_icrs_matrix(t) @ v
        return np.degrees(np.arctan2(w[1], w[0])) % 360.0

    sidereal = 86164.0905
    assert abs(ra_of(t0 + sidereal) - ra_of(t0)) < 0.01
    drift = (ra_of(t0 + 86400.0) - ra_of(t0)) % 360.0
    assert abs(drift - 0.9856) < 0.01
    # and the matrix is a rotation
    M = loc.itrs_to_icrs_matrix(t0)
    np.testing.assert_allclose(M @ M.T, np.eye(3), atol=1e-12)


def test_itrs_zenith_maps_to_vla_latitude():
    """The geocentric up direction at the VLA maps to dec = geocentric
    latitude (~33.9 deg) regardless of time (precession-level tolerance)."""
    up = loc.VLA_CENTER_ITRS / np.linalg.norm(loc.VLA_CENTER_ITRS)
    lat = np.degrees(np.arcsin(up[2]))
    for t in (1.5e9, 1.75e9):
        w = loc.itrs_to_icrs_matrix(t) @ up
        dec = np.degrees(np.arcsin(w[2]))
        assert abs(dec - lat) < 0.5


def test_parse_correlator_delays():
    text = """# vliteantennas.in
0 10 vlite-difx7 p1p2 5021.000000 E08 5021.000000 1
1 3 vlite-difx2 p1p2 -120.500000 W04 -120.500000 1

bad line
2 24 vlite-difx1 p1p2 0.000000 N02 0.000000 1
"""
    d = loc.parse_correlator_delays(text)
    assert d == pytest.approx({10: 5021.0e-9, 3: -120.5e-9, 24: 0.0})


def test_parse_correlator_delays_path_with_space(tmp_path):
    """A single-line argument is a file PATH — spaces and all; a
    mistyped path raises instead of silently parsing as empty text
    (which would yield all-zero clock offsets and a confidently wrong
    RA/Dec)."""
    d = tmp_path / "obs run1"
    d.mkdir()
    p = d / "vliteantennas.in"
    p.write_text("0 10 vlite-difx7 p1p2 5021.000000 E08 5021.000000 1\n")
    assert loc.parse_correlator_delays(str(p)) == pytest.approx(
        {10: 5021.0e-9})
    with pytest.raises(FileNotFoundError):
        loc.parse_correlator_delays(str(d / "nope.in"))


def test_fit_sky_recovers_injected_radec():
    """Exact-delay round trip at real VLA coordinates: pick a visible sky
    direction, model the baseline delays (with per-antenna clock
    offsets), and fit_sky must recover it to sub-arcminute."""
    rng = np.random.default_rng(40)
    doc_positions = rng.uniform(-8000, 8000, (6, 3))
    # place on the local tangent plane at the VLA (coplanar like the
    # real array -> exercises the horizon disambiguation too)
    up = loc.VLA_CENTER_ITRS / np.linalg.norm(loc.VLA_CENTER_ITRS)
    east = np.cross([0.0, 0.0, 1.0], up)
    east /= np.linalg.norm(east)
    north = np.cross(up, east)
    positions = (loc.VLA_CENTER_ITRS
                 + doc_positions[:, :1] * east
                 + doc_positions[:, 1:2] * north)
    t0 = 1.77e9
    M = loc.itrs_to_icrs_matrix(t0)
    # a direction 30 deg from zenith (visible), rotated into ICRS
    s_itrs = loc.direction_unit(np.array(1.0), np.array(np.pi / 3))
    s_itrs = s_itrs[0] * east + s_itrs[1] * north + s_itrs[2] * up
    s_icrs = M @ s_itrs
    ra_true = np.degrees(np.arctan2(s_icrs[1], s_icrs[0])) % 360.0
    dec_true = np.degrees(np.arcsin(s_icrs[2]))
    pairs = [(i, j) for i in range(6) for j in range(i + 1, 6)]
    clocks = rng.normal(0, 2e-7, 6)
    delays = np.array([(positions[j] - positions[i]) @ s_itrs
                       for i, j in pairs]) / loc.C_LIGHT
    delays = delays + np.array([clocks[i] - clocks[j] for i, j in pairs])
    fit = loc.fit_sky(positions, pairs, delays, t0=t0, sigma=10e-9,
                      clock_offsets=clocks)
    assert abs(fit.dec_deg - dec_true) < 1 / 60.0
    dra = (fit.ra_deg - ra_true + 180) % 360 - 180
    assert abs(dra * np.cos(np.radians(dec_true))) < 1 / 60.0
    assert fit.err_arcmin < 30.0
