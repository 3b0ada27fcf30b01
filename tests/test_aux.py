"""Aux subsystem tests: VLA XML parsing, dump unwrap, watchdog, recorder,
waterfall, CLI."""

import json
import subprocess
import sys

import numpy as np
import pytest

from vlite_fast import constants as C
from vlite_fast.analysis import unwrap as uw
from vlite_fast.analysis import waterfall as wfm
from vlite_fast.runtime import vla_xml, watchdog, recorder
from vlite_fast.utils import vdif


OBS_XML = """<?xml version="1.0"?>
<Observation datasetId="X_osro.57889" configId="cfg-1"
             startTime="57889.12345">
  <name>J0534+2200</name>
  <ra>1.4596748</ra>
  <dec>0.3842255</dec>
  <scanNo>5</scanNo>
  <subscanNo>1</subscanNo>
  <intent>OBSERVE_TARGET</intent>
</Observation>"""

FINISH_XML = OBS_XML.replace("OBSERVE_TARGET", "FINISH")

ANTPROP_XML = """<?xml version="1.0"?>
<AntennaPropertyTable creation="57889.1" datasetID="X1"
                      configuration="B">
  <AntennaProperties name="ea05">
    <X>-1601.2</X><Y>480.1</Y><Z>12.5</Z><axisOffset>2.1</axisOffset>
  </AntennaProperties>
  <AntennaProperties name="ea12">
    <X>93.9</X><Y>-210.0</Y><Z>3.3</Z><axisOffset>2.0</axisOffset>
  </AntennaProperties>
  <eopday><epoch>57889</epoch><tai_utc>37.0</tai_utc>
    <ut1_utc>0.41</ut1_utc><x_pole>0.1</x_pole><y_pole>0.3</y_pole>
  </eopday>
</AntennaPropertyTable>"""

ALERT_XML = """<EVLAMessage location="ea07-fe" timestamp="57889.5">
  <device name="frontend"><monitor name="lowTemp" alert="1"/></device>
</EVLAMessage>"""


class TestVlaXml:
    def test_obs(self):
        od = vla_xml.parse_obs_document(OBS_XML)
        assert od.name == "J0534+2200"
        assert abs(od.ra - 1.4596748) < 1e-9
        assert od.scan_no == 5 and od.subscan_no == 1
        assert od.datasetId == "X_osro.57889"
        assert not od.finishes

    def test_finish_intent(self):
        assert vla_xml.parse_obs_document(FINISH_XML).finishes

    def test_antprop(self):
        ap = vla_xml.parse_antprop_document(ANTPROP_XML)
        assert ap.array_configuration == "B"
        assert set(ap.antennas) == {5, 12}
        assert ap.antennas[5].X == -1601.2
        assert ap.eops[0].mjd == 57889
        assert ap.eops[0].tai_utc == 37.0

    def test_alert(self):
        al = vla_xml.parse_alert_document(ALERT_XML)
        assert al.vla_ant == 7
        assert al.location_suffix == "fe"
        assert al.device_name == "frontend"
        assert al.alert_state == 1

    def test_dispatch(self):
        assert vla_xml.parse_scaninfo(OBS_XML).name == "J0534+2200"
        assert 5 in vla_xml.parse_scaninfo(ANTPROP_XML).antennas
        assert vla_xml.parse_scaninfo(ALERT_XML).vla_ant == 7
        with pytest.raises(ValueError):
            vla_xml.parse_scaninfo("<Bogus/>")


class TestUnwrap:
    def _stream(self, rate=50_000, nsec=3, start=100):
        samples = np.random.default_rng(0).integers(
            1, 255, (2, rate * nsec), dtype=np.uint8)
        return vdif.streams_to_frames(samples, 40, start,
                                      sample_rate=rate), rate

    def test_clean(self):
        raw, rate = self._stream()
        rep = uw.find_discontinuity(raw, frames_per_sec=rate // 5000)
        assert rep.clean and rep.discontinuities == (0, 0)

    def test_wrap_detect_and_fix(self):
        raw, rate = self._stream()
        fps = rate // 5000
        # simulate a dump that started mid-ring AND lost a few frames at
        # the overwrite boundary (a pure whole-period rotation is cyclic
        # in frame numbers and genuinely invisible to db_unwrap too)
        a = C.VDIF_FRAME_BYTES
        cut = 13 * a
        wrapped = np.concatenate([raw[cut:], raw[6 * a:cut]])
        rep = uw.find_discontinuity(wrapped, frames_per_sec=fps)
        assert not rep.clean and not rep.corrupted
        assert rep.discontinuities == (1, 1)
        fixed = uw.unwrap(wrapped, rep)
        rep2 = uw.find_discontinuity(fixed, frames_per_sec=fps)
        assert rep2.clean

    def test_corrupt_raises(self):
        raw, rate = self._stream()
        fps = rate // 5000
        a = C.VDIF_FRAME_BYTES
        mangled = np.concatenate([raw[: 4 * a], raw[8 * a: 12 * a],
                                  raw[16 * a: 20 * a], raw[24 * a:]])
        rep = uw.find_discontinuity(mangled, frames_per_sec=fps)
        assert rep.corrupted
        with pytest.raises(ValueError):
            uw.unwrap(mangled, rep)


class TestSpectral:
    def test_real_to_complex_tone(self):
        from vlite_fast.analysis import spectral
        n = 4096
        t = np.arange(n)
        # tone at 0.2 cycles/sample (= 0.4 of the real Nyquist)
        x = np.cos(2 * np.pi * 0.2 * t).astype(np.float32)
        z = spectral.real_to_complex(x, shift_band=False)
        assert z.dtype == np.complex64 and len(z) == n // 2
        spec = np.abs(np.fft.fft(z))
        # analytic signal: single-sided tone at 0.4 of the complex rate
        k = np.argmax(spec)
        assert abs(k / len(z) - 0.4) < 0.01
        # power preserved (x2 for analytic one-sided)
        assert abs((np.abs(z) ** 2).mean() / (x ** 2).mean() - 2) < 0.2

    def test_fscrunch(self):
        from vlite_fast.analysis import spectral
        fb = np.arange(9, dtype=np.float32)
        out = spectral.fscrunch(fb, 1)
        assert out[0] == 0 and out[1] == (1 + 2) / 2

    def test_cyclic_spectrum_modulation(self):
        from vlite_fast.analysis import spectral
        rng = np.random.default_rng(0)
        n = 64 * 1024
        x = rng.standard_normal(n).astype(np.float32)
        out = spectral.cyclic_spectrum(x, nfft=512, lags=4)
        assert out.shape == (4, 257)
        # lag 0 = power spectrum: real positive
        assert np.all(out[0].real > 0)
        # white noise: higher-lag correlations sit at the 1/sqrt(nspec)
        # noise floor, well below lag 0
        assert np.abs(out[1:]).mean() < 0.15 * np.abs(out[0]).mean()

    def test_filter_muos_isolates_band(self):
        from vlite_fast.analysis import spectral
        rng = np.random.default_rng(1)
        n = 1 << 16
        fs = 128e6
        t = np.arange(n) / fs
        # a strong tone inside band 1's passband (the reference code
        # selects complex frequencies [4, 9] MHz after the band-1 shift)
        x = rng.standard_normal(n).astype(np.float32)
        x += 10 * np.cos(2 * np.pi * 6.5e6 * t).astype(np.float32)
        y = spectral.filter_muos(x, band=1, sample_rate=fs)
        # the filtered signal retains most of the tone's power
        assert (np.abs(y) ** 2).mean() > 5 * 1.0
        # and a clean-noise signal mostly filtered away
        y2 = spectral.filter_muos(
            rng.standard_normal(n).astype(np.float32), band=1,
            sample_rate=fs)
        assert (np.abs(y2) ** 2).mean() < 1.0


class TestJoinDumps:
    def test_join(self, tmp_path):
        rate = 50_000
        samples = np.random.default_rng(3).integers(
            1, 255, (2, rate * 2), dtype=np.uint8)
        stream = vdif.streams_to_frames(samples, 40, 70, sample_rate=rate)
        half = stream.size // 2
        half -= half % C.VDIF_FRAME_BYTES
        (tmp_path / "b.vdif").write_bytes(stream[half:].tobytes())
        (tmp_path / "a.vdif").write_bytes(stream[:half].tobytes())
        out = tmp_path / "joined.vdif"
        rep = uw.join_dumps([str(tmp_path / "b.vdif"),
                             str(tmp_path / "a.vdif")], str(out),
                            frames_per_sec=rate // 5000)
        assert rep.clean
        np.testing.assert_array_equal(
            np.fromfile(out, np.uint8), stream)

    def test_cli(self, tmp_path, capsys):
        from vlite_fast import cli
        rate = 25_000
        samples = np.random.default_rng(5).integers(
            1, 255, (2, rate), dtype=np.uint8)
        stream = vdif.streams_to_frames(samples, 40, 70, sample_rate=rate)
        half = stream.size // 2
        half -= half % C.VDIF_FRAME_BYTES
        (tmp_path / "p1.vdif").write_bytes(stream[half:].tobytes())
        (tmp_path / "p0.vdif").write_bytes(stream[:half].tobytes())
        out = tmp_path / "j.vdif"
        cli.main(["join-dumps", str(tmp_path / "p1.vdif"),
                  str(tmp_path / "p0.vdif"), "-o", str(out)])
        import json as _json
        rep = _json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rep["out"] == str(out) and not rep["corrupted"]
        np.testing.assert_array_equal(np.fromfile(out, np.uint8), stream)


class TestWatchdog:
    def test_escalating_counter(self):
        c = watchdog.EscalatingCounter("skips", warn=3, abort=6)
        assert c.add() is None
        assert c.add(2) == "warn"
        assert c.add() is None       # warned once
        assert c.add(2) == "abort"
        c.reset()
        assert c.count == 0 and not c.warned

    def test_stall_detector(self):
        s = watchdog.StallDetector(timeout=10.0)
        s.beat("capture", now=0.0)
        s.beat("dsp", now=5.0)
        assert s.check(now=9.0) == []
        assert s.check(now=12.0) == ["capture"]
        assert set(s.check(now=20.0)) == {"capture", "dsp"}


class TestRecorder:
    def test_periodic(self):
        trigs = list(recorder.periodic_triggers(100.0, interval=2.0,
                                                duration=1.0, count=3))
        assert [t.t0 for t in trigs] == [100.0, 102.0, 104.0]
        assert all(t.t1 - t.t0 == 1.0 for t in trigs)

    def test_run_recorder(self):
        seen = []
        n = recorder.run_recorder(seen.append, interval=0.5, count=4)
        assert n == 4 and len(seen) == 4


class TestWaterfall:
    def test_downsample(self):
        d = np.arange(64 * 32, dtype=np.float32).reshape(64, 32)
        w = wfm.downsample(d, max_time=16, max_chan=8)
        assert w.shape == (16, 8)
        assert abs(w.mean() - d.mean()) < 1e-3

    def test_candidate_png(self, tmp_path):
        import os
        from vlite_fast.ops.dedisperse import Candidate
        rng = np.random.default_rng(7)
        fb = rng.standard_normal((800, 32)).astype(np.float32)
        freqs = 384.0 - np.arange(32) * 0.1
        c = Candidate(snr=12.0, peak_idx=400, peak_time=0.8, tfilt=2,
                      dmi=5, dm=80.0, ngiant=3, i0=395, i1=405)
        out = wfm.render_candidate_png(fb, c, 2e-3, freqs,
                                       str(tmp_path / "cand.png"))
        assert os.path.getsize(out) > 5000

    def test_png(self, tmp_path):
        wf = np.random.default_rng(0).standard_normal((100, 50))
        out = wfm.render_png(wf, {"tsamp": 0.1, "fch1": 384.0,
                                  "foff": -0.1, "source": "test"},
                             str(tmp_path / "wf.png"))
        import os
        assert os.path.getsize(out) > 1000


class TestCLI:
    def test_synth_and_unwrap(self, tmp_path):
        out = tmp_path / "synth.vdif"
        from vlite_fast import cli
        cli.main(["synth", "-t", "0.5", "-d", "0", "-p", "0.1",
                  "--rate", "1000000", "--bandwidth", "0.5",
                  "--buflen", "250000", "-o", str(out)])
        assert out.stat().st_size > 100_000
        cli.main(["unwrap", str(out)])


def test_perf_cost_models():
    """utils/perf: the analytic cost models track the geometry and the
    XLA cost hook degrades gracefully."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from vlite_fast.config import PipelineConfig
    from vlite_fast.utils import perf

    cfg = PipelineConfig()          # production geometry
    dft = perf.dft_flops_per_data_second(cfg)
    # 2 pol x 10240 frames x (4*100^2*125 + 8*100*125*63) flops
    assert dft["nominal_flops"] == 2 * 10240 * (4 * 100 * 100 * 125
                                                + 8 * 100 * 125 * 63)
    assert dft["hw_bf16_flops"] == 3 * dft["nominal_flops"]  # bf16x3
    assert perf.chain_hbm_bytes_per_data_second(cfg) > 2 * 4 * 2 * 128e6

    out = perf.xla_cost(jax.jit(lambda x: jnp.sum(x * 2)),
                        np.ones(16, np.float32))
    assert isinstance(out, dict)    # {} allowed on unsupported backends
