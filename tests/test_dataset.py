"""Offline dump-dataset framework + precision delay fitting + loc_step1
cleaning (VERDICT round-1 item 5).

End-to-end criterion: synthesized 4-antenna dump FILES of a known-geometry
pulse — with ragged start times and one antenna split across two fragment
files — go dump-files -> dataset -> phase-slope delays -> TDOA fit and
recover the injected direction, through the public API only.
"""

import numpy as np
import pytest

from vlite_fast.analysis import baseband as bb
from vlite_fast.analysis import localization as loc
from vlite_fast.analysis.dataset import (BasebandFragment,
                                             BasebandFragments,
                                             load_dataset)
from vlite_fast.utils import vdif
from vlite_fast import constants as C

RATE = 1_000_000
FPS = RATE // 5000          # frames/s/pol at the tiny rate


def frac_shift(x: np.ndarray, shift_samples: float) -> np.ndarray:
    """Delay a real 1-D signal by a (fractional) number of samples."""
    n = x.size
    X = np.fft.rfft(x)
    f = np.fft.rfftfreq(n)
    return np.fft.irfft(X * np.exp(-2j * np.pi * f * shift_samples), n=n)


def write_dump(tmp_path, name, samples, station, sec0, frame0):
    stream = vdif.streams_to_frames(samples, ref_epoch=40,
                                    start_second=sec0, start_frame=frame0,
                                    station_id=station, sample_rate=RATE)
    p = tmp_path / name
    stream.tofile(p)
    return str(p)


def test_fragment_metadata_ragged_start(tmp_path):
    rng = np.random.default_rng(0)
    u = rng.integers(1, 255, (2, 40 * 5000), dtype=np.uint8)
    path = write_dump(tmp_path, "a.vdif", u, station=3, sec0=9, frame0=17)
    f = BasebandFragment.from_file(path, sample_rate=RATE)
    assert f.station_id == 3
    assert f.nsamp == 40 * 5000
    base = float(vdif._epoch_unix(40))
    assert abs(f.start_time - (base + 9 + 17 * 5000 / RATE)) < 1e-9
    rep = f.continuity()
    assert rep.clean


def test_fragments_gap_fill(tmp_path):
    rng = np.random.default_rng(1)
    u = rng.integers(1, 255, (2, 60 * 5000), dtype=np.uint8)
    # fragment 1: frames 0-19; fragment 2: frames 30-59 (10-frame gap)
    p1 = write_dump(tmp_path, "f1.vdif", u[:, :20 * 5000], 1, 9, 0)
    p2 = write_dump(tmp_path, "f2.vdif", u[:, 30 * 5000:], 1, 9, 30)
    frags = BasebandFragments([BasebandFragment.from_file(p, RATE)
                               for p in (p1, p2)])
    assert frags.gap_samples() == [10 * 5000]
    out = frags.read(9 * RATE, 9 * RATE + 60 * 5000)
    np.testing.assert_array_equal(out[:, :20 * 5000], u[:, :20 * 5000])
    assert np.all(out[:, 20 * 5000:30 * 5000] == 0)       # gap zero-filled
    np.testing.assert_array_equal(out[:, 30 * 5000:], u[:, 30 * 5000:])


def test_dataset_aligned_ragged_starts(tmp_path):
    rng = np.random.default_rng(2)
    n = 50 * 5000
    u = rng.integers(1, 255, (2, n + 40 * 5000), dtype=np.uint8)
    # two stations dumping the SAME stream but cut at different frames
    write_dump(tmp_path, "a.vdif", u[:, :n], 1, 9, 0)
    off = 13
    write_dump(tmp_path, "b.vdif", u[:, off * 5000:off * 5000 + n],
               2, 9, off)
    ds = load_dataset(str(tmp_path), sample_rate=RATE)
    assert ds.station_ids == [1, 2]
    dumps = ds.aligned()
    assert dumps[0].start_time == dumps[1].start_time
    # on the common clock the content must be identical
    np.testing.assert_array_equal(dumps[0].samples, dumps[1].samples)


def test_blocks_iterator_overlap(tmp_path):
    rng = np.random.default_rng(3)
    n = 40 * 5000
    u = rng.integers(1, 255, (2, n), dtype=np.uint8)
    write_dump(tmp_path, "a.vdif", u, 1, 9, 0)
    ds = load_dataset(str(tmp_path), sample_rate=RATE)
    blocks = list(ds.blocks(block_samps=60_000, overlap=10_000))
    assert len(blocks) == (n - 60_000) // 50_000 + 1
    for blk in blocks:
        assert blk[0].nsamp == 60_000
    # consecutive blocks overlap by exactly 10k samples
    a_end = blocks[0][0].samples[:, -10_000:]
    b_start = blocks[1][0].samples[:, :10_000]
    np.testing.assert_array_equal(a_end, b_start)


def test_phase_slope_subsample_delay():
    """Fractional delays resolved to <0.1 sample (the reference's
    phase-slope fitting, analysis/baseband.py:723-806)."""
    rng = np.random.default_rng(4)
    n = 400_000
    common = rng.standard_normal(n + 64).astype(np.float64)
    true = 4.37                      # samples
    sa = common[:n]
    sb = frac_shift(common, true)[:n]
    ua = np.clip(np.stack([sa, sa]) * 30 + 128.5, 0, 255).astype(np.uint8)
    ub = np.clip(np.stack([sb, sb]) * 30 + 128.5, 0, 255).astype(np.uint8)
    a = bb.VoltageDump(samples=ua, start_time=0, station_id=1,
                       sample_rate=RATE)
    b = bb.VoltageDump(samples=ub, start_time=0, station_id=2,
                       sample_rate=RATE)
    tau, coh, snr = bb.baseline_delay_precise(a, b, nfft=500)
    # convention: baseline_delay(a, b) = tau_a - tau_b; b lags -> negative
    assert abs(tau * RATE + true) < 0.1
    assert coh > 0.8
    assert snr > 10


def test_e2e_dumps_to_localization(tmp_path):
    """The VERDICT item-5 'done' bar, via files on disk."""
    rng = np.random.default_rng(5)
    nant, n = 4, 320_000
    positions = np.array([[0.0, 0.0, 0.0], [2400.0, 0.0, 0.0],
                          [0.0, 2400.0, 0.0], [900.0, 1700.0, 0.0]])
    az_true, el_true = 1.1, 0.7
    s_hat = loc.direction_unit(np.array(az_true), np.array(el_true))
    tau = positions @ s_hat / loc.C_LIGHT          # arrival offsets [s]
    margin = 4000
    extra = 16 * 5000                              # room for ragged cuts
    common = np.zeros(n + 2 * margin + extra, np.float64)
    common[rng.integers(margin, n, 60)] = 20.0     # broadband impulses
    common += 0.3 * rng.standard_normal(common.size)
    sec0 = 9
    for k in range(nant):
        # physical: closer antennas (larger r.s_hat) receive EARLIER ->
        # advance by tau (frac_shift delays, so pass -tau)
        sig = frac_shift(common, -tau[k] * RATE)[margin:margin + n + extra]
        x = np.stack([sig, sig]) + 0.5 * rng.standard_normal(
            (2, sig.size))
        u = np.clip(x * 12.8 + 128.5, 0, 255).astype(np.uint8)
        off = int(rng.integers(0, 15))             # ragged start frames
        cut = u[:, off * 5000: off * 5000 + n]
        if k == 2:   # split one antenna across two fragment files
            h = (cut.shape[1] // 2 // 5000) * 5000
            write_dump(tmp_path, "c1.vdif", cut[:, :h], k + 1, sec0, off)
            write_dump(tmp_path, "c2.vdif", cut[:, h:], k + 1, sec0,
                       off + h // 5000)
        else:
            write_dump(tmp_path, f"ant{k}.vdif", cut, k + 1, sec0, off)

    ds = load_dataset(str(tmp_path), sample_rate=RATE)
    assert len(ds.station_ids) == nant
    dumps = ds.aligned()
    pairs = [(i, j) for i in range(nant) for j in range(i + 1, nant)]
    delays = []
    for i, j in pairs:
        d, coh, snr = bb.baseline_delay_precise(dumps[i], dumps[j],
                                                nfft=500)
        delays.append(d)
    fit = loc.fit_tdoa(positions, pairs, np.array(delays),
                       sigma=0.7 / RATE)
    assert abs(fit.az - az_true) < 0.1
    assert abs(fit.el - el_true) < 0.1


def test_clean_coherent_dedisperse_beats_raw_chirp():
    """loc_step1 semantics: with narrowband RFI riding on a dispersed
    pulse, bandpass flattening + RFI excision BEFORE the inverse chirp
    must yield a cleaner recovered pulse than the raw chirp."""
    from vlite_fast.models import synthesis
    from vlite_fast.ops import coherent as coh
    import jax.numpy as jnp
    dm, rate = 40.0, RATE
    s = synthesis.SynthConfig(tobs=0.4, dm=dm, pulse_period=0.1,
                              skip_period=4, amp=1.2, seed=11,
                              sample_rate=rate, freq_bot_mhz=320.0,
                              bandwidth_mhz=0.5, buflen=250_000)
    samples, _ = synthesis.generate_baseband(s)
    x = samples.astype(np.float32) / 128.0 - 1.0
    n = x.shape[1]
    # inject a strong narrowband RFI tone (MUOS stand-in)
    t = np.arange(n)
    x = x + 1.5 * np.sin(2 * np.pi * 0.137 * t)[None, :].astype(np.float32)

    def peak_snr(y):
        p = y[0] ** 2 + y[1] ** 2
        prof = p.reshape(-1, 1000).sum(axis=1)
        med = np.median(prof)
        mad = np.median(np.abs(prof - med)) + 1e-12
        return (prof.max() - med) / (1.4826 * mad)

    xs = np.asarray(coh.swap_sideband(jnp.asarray(x)))
    raw = np.asarray(coh.coherent_dedisperse(
        jnp.asarray(xs), dm, rate, bandwidth_mhz=0.5, freq_bot_mhz=320.0))
    cleaned, flags = bb.clean_coherent_dedisperse(
        xs, dm, rate, bandwidth_mhz=0.5, freq_bot_mhz=320.0,
        smooth_bins=2001, rfi_sigma=5.0)
    assert flags.any()                       # the tone was caught
    assert peak_snr(cleaned) > peak_snr(raw)
    assert peak_snr(cleaned) > 8.0


def test_cli_localize(tmp_path, capsys):
    """The researcher-facing command over the same dump set."""
    import json
    from vlite_fast import cli
    rng = np.random.default_rng(9)
    nant, n = 3, 200_000
    positions = np.array([[0.0, 0.0, 0.0], [2000.0, 0.0, 0.0],
                          [0.0, 2000.0, 0.0]])
    az_true, el_true = 0.8, 0.9
    s_hat = loc.direction_unit(np.array(az_true), np.array(el_true))
    tau = positions @ s_hat / loc.C_LIGHT
    margin = 2000
    common = np.zeros(n + 2 * margin, np.float64)
    common[rng.integers(margin, n, 40)] = 20.0
    common += 0.3 * rng.standard_normal(common.size)
    for k in range(nant):
        sig = frac_shift(common, -tau[k] * RATE)[margin:margin + n]
        x = np.stack([sig, sig]) + 0.5 * rng.standard_normal((2, n))
        u = np.clip(x * 12.8 + 128.5, 0, 255).astype(np.uint8)
        write_dump(tmp_path, f"a{k}.vdif", u, k + 1, 9, 0)
    posfile = tmp_path / "pos.json"
    posfile.write_text(json.dumps({str(k + 1): list(positions[k])
                                   for k in range(nant)}))
    cli.main(["localize", str(tmp_path), "--positions", str(posfile),
              "--nfft", "500", "--sigma-ns",
              str(0.7 / RATE * 1e9), "--sample-rate", str(RATE)])
    out = capsys.readouterr().out.strip().splitlines()
    res = json.loads(out[-1])
    assert abs(res["az_rad"] - az_true) < 0.15
    assert abs(res["el_rad"] - el_true) < 0.15


def test_fragment_intra_file_gap_and_wrap(tmp_path):
    """A dump file with a missing mid-file frame pair and a ring-wrap
    rotation must decode with every sample at its true position (zeros in
    the gap) — blind frame concatenation shifted everything after the
    gap by one frame."""
    rate = 25_000
    fps = rate // 5000
    samples = np.random.default_rng(8).integers(
        1, 255, (2, rate * 2), dtype=np.uint8)
    stream = vdif.streams_to_frames(samples, 40, 70, sample_rate=rate)
    frames = stream.reshape(-1, C.VDIF_FRAME_BYTES)
    # drop frame-pair index 3 (both pols) and rotate by 5 frame pairs
    keep = np.ones(len(frames), bool)
    keep[6:8] = False
    frames = frames[keep]
    frames = np.roll(frames, -10, axis=0)
    p = tmp_path / "gappy.vdif"
    frames.tofile(p)
    frag = BasebandFragment.from_file(str(p), sample_rate=rate)
    # start/nsamp reflect the true min/max frames, not file order
    assert frag.start_sample == 70 * rate
    assert frag.nsamp == 2 * rate
    got = frag.load()
    # gap (frame 3 of second 0) is zero-filled
    gap0 = 3 * 5000
    assert (got[:, gap0:gap0 + 5000] == 0).all()
    # everything else is at its TRUE position
    mask = np.ones(2 * rate, bool)
    mask[gap0:gap0 + 5000] = False
    np.testing.assert_array_equal(got[:, mask], samples[:, mask])


def test_e2e_sky_localization_antprop_cli(tmp_path, capsys):
    """The loc_step3 end product through the public CLI (VERDICT r2
    'missing' item 1): a pulse injected from a known SKY direction into
    5 antennas at real VLA coordinates (antprop-style X/Y/Z offsets from
    the array center), with per-antenna instrumental clock delays, must
    come back as RA/Dec from `vlite-fast localize --antprop
    --clock-delays`.  The expected RA/Dec is computed in the test from
    standard horizontal->equatorial formulas, independent of the
    module's ITRS->ICRS matrix chain."""
    import json
    from vlite_fast import cli

    rng = np.random.default_rng(41)
    # local tangent basis at the VLA (geocentric up)
    center = loc.VLA_CENTER_ITRS
    up = center / np.linalg.norm(center)
    east = np.cross([0.0, 0.0, 1.0], up)
    east /= np.linalg.norm(east)
    north = np.cross(up, east)

    # 5 antennas on Y-shaped km-scale arms (B-config-like), coplanar
    enu = np.array([[0.0, 0.0], [-1800.0, 2600.0], [2100.0, 2400.0],
                    [-300.0, -3500.0], [2900.0, -900.0]])
    offsets = enu[:, :1] * east + enu[:, 1:2] * north   # ITRS offsets
    ants = list(range(1, 6))
    props = "".join(
        f'<AntennaProperties name="ea{a:02d}"><X>{o[0]:.3f}</X>'
        f'<Y>{o[1]:.3f}</Y><Z>{o[2]:.3f}</Z>'
        f'<axisOffset>0</axisOffset></AntennaProperties>'
        for a, o in zip(ants, offsets))
    (tmp_path / "antprop.xml").write_text(
        '<AntennaPropertyTable creation="59000.0" configuration="B">'
        + props +
        '<eopday><epoch>59000</epoch><tai_utc>37</tai_utc>'
        '<ut1_utc>0.0</ut1_utc><x_pole>0</x_pole><y_pole>0</y_pole>'
        '</eopday></AntennaPropertyTable>')

    clocks_ns = np.array([0.0, 850.0, -420.0, 310.0, -1200.0])
    (tmp_path / "vliteantennas.in").write_text("".join(
        f"{k} {a} vlite-difx{k + 1} p1p2 {c:.6f} E{k:02d} {c:.6f} 1\n"
        for k, (a, c) in enumerate(zip(ants, clocks_ns))))

    # source 30 deg from zenith at az=2.1 rad; event time from the VDIF
    # clock (ref epoch 40 = 2020-01-01, second 1234)
    az_t, el_t = 2.1, np.pi / 3
    s_enu = loc.direction_unit(np.array(az_t), np.array(el_t))
    s_itrs = s_enu[0] * east + s_enu[1] * north + s_enu[2] * up
    sec0 = 1234
    t0 = float(vdif._epoch_unix(40)) + sec0

    n = 320_000
    tau = (offsets @ s_itrs) / loc.C_LIGHT         # geometric advance
    shift = -tau + clocks_ns * 1e-9                # + instrumental delay
    margin = 4000
    common = np.zeros(n + 2 * margin, np.float64)
    common[rng.integers(margin, n, 60)] = 20.0
    common += 0.3 * rng.standard_normal(common.size)
    for k, a in enumerate(ants):
        sig = frac_shift(common, shift[k] * RATE)[margin:margin + n]
        x = np.stack([sig, sig]) + 0.5 * rng.standard_normal((2, n))
        u = np.clip(x * 12.8 + 128.5, 0, 255).astype(np.uint8)
        write_dump(tmp_path, f"ea{a:02d}.vdif", u, a, sec0, 0)

    cli.main(["localize", str(tmp_path),
              "--antprop", str(tmp_path / "antprop.xml"),
              "--clock-delays", str(tmp_path / "vliteantennas.in"),
              "--nfft", "500", "--sigma-ns", "100",
              "--sample-rate", str(RATE)])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    # independent expectation: horizontal -> equatorial at geocentric
    # latitude, RA = LST - H (precession ~0.4 deg is inside the 1.5 deg
    # TDOA tolerance of these baselines at this sample rate)
    lat = np.arcsin(up[2])
    dec_exp = np.arcsin(np.sin(el_t) * np.sin(lat)
                        + np.cos(el_t) * np.cos(lat) * np.cos(az_t))
    H = np.arctan2(-np.sin(az_t) * np.cos(el_t),
                   np.sin(el_t) * np.cos(lat)
                   - np.cos(el_t) * np.sin(lat) * np.cos(az_t))
    lon_east = np.arctan2(center[1], center[0])
    ra_exp = (loc.gmst_rad(t0) + lon_east - H) % (2 * np.pi)

    assert abs(res["dec_deg"] - np.degrees(dec_exp)) < 1.5
    dra = (res["ra_deg"] - np.degrees(ra_exp) + 180) % 360 - 180
    assert abs(dra * np.cos(dec_exp)) < 1.5
    assert res["dec_deg"] > -90 and res["err_arcmin"] > 0
