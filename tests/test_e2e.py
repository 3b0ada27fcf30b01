"""The minimum end-to-end slice (SURVEY.md section 7 step 2-4):
synthetic dispersed baseband -> full DSP chain -> filterbank -> dedispersion
search -> candidate at the injected DM.  Mirrors the reference's
baseband_test harness (scripts/baseband_test:20) as a real unit test."""

import numpy as np
import pytest
import jax.numpy as jnp

from vlite_fast.config import PipelineConfig, SearchConfig
from vlite_fast.models import baseband_dsp as dsp
from vlite_fast.models import search as search_mod
from vlite_fast.models import synthesis

DM_TRUE = 300.0


def make_filterbank(nbit=8, seconds=2):
    cfg = PipelineConfig.tiny(nbit=nbit, sample_rate=1_000_000,
                              freq_top_mhz=320.5, bandwidth_mhz=0.5)
    synth = synthesis.SynthConfig(
        tobs=float(seconds), dm=DM_TRUE, pulse_period=0.05, skip_period=16,
        amp=0.4, seed=21, sample_rate=cfg.sample_rate,
        freq_bot_mhz=320.0, bandwidth_mhz=0.5, buflen=250_000)
    samples, info = synthesis.generate_baseband(synth)
    state = dsp.init_state(cfg)
    blocks = []
    for s in range(seconds):
        raw = samples[:, s * cfg.sample_rate:(s + 1) * cfg.sample_rate]
        out, state = dsp.process_second(cfg, jnp.asarray(raw), state,
                                        jnp.asarray(False))
        blocks.append(np.asarray(out.packed_kur))
    packed = np.concatenate(blocks, axis=0)
    fb = search_mod.filterbank_from_packed(packed, cfg.nbit, cfg.nchanout)
    return cfg, synth, info, fb


@pytest.fixture(scope="module")
def fb_setup():
    return make_filterbank()


def test_filterbank_statistics(fb_setup):
    cfg, synth, info, fb = fb_setup
    # normalized filterbank: mean ~0, std ~1 off-pulse
    assert abs(np.median(fb)) < 0.2
    assert 0.5 < fb.std() < 2.0


def test_pulse_recovered_at_dm(fb_setup):
    cfg, synth, info, fb = fb_setup
    freqs = cfg.freqs_mhz()
    scfg = SearchConfig(dm_min=0.0, dm_max=600.0, ndm=121, gulp_samps=512,
                        boxcar_max=16, zap_ranges=(), snr_thresh=6.0)
    eng = search_mod.SinglePulseSearch(scfg, cfg.tsamp, freqs,
                                      nsub=16, nbatch=121)
    cands = eng.search_stream(fb)
    assert len(cands) >= 1, "injected pulse not detected"
    top = max(cands, key=lambda c: c.snr)
    assert top.snr > scfg.snr_thresh
    assert abs(top.dm - DM_TRUE) < 75.0, f"DM {top.dm} != {DM_TRUE}"
    # pulse period 0.05*16 = 0.8 s -> top-of-band arrivals every 0.8 s
    # (tsamp 2 ms -> every 400 samples)
    assert (top.peak_idx % 400) < 30 or (top.peak_idx % 400) > 370


def test_pulse_recovered_2bit():
    """Same slice through the PRODUCTION output format: 2-bit packed
    filterbank (the reference's default NBIT=2,
    ref process_baseband.cu:34)."""
    cfg, synth, info, fb = make_filterbank(nbit=2)
    freqs = cfg.freqs_mhz()
    scfg = SearchConfig(dm_min=0.0, dm_max=600.0, ndm=121, gulp_samps=512,
                        boxcar_max=16, zap_ranges=(), snr_thresh=6.0)
    eng = search_mod.SinglePulseSearch(scfg, cfg.tsamp, freqs,
                                      nsub=16, nbatch=121)
    cands = eng.search_stream(fb)
    assert cands, "pulse lost in 2-bit quantization"
    top = max(cands, key=lambda c: c.snr)
    assert abs(top.dm - DM_TRUE) < 75.0
    assert top.snr > 8.0


def test_dm_grid_tol():
    from vlite_fast.ops import dedisperse as dd
    freqs = np.asarray(
        [384.0 - i * (64.0 / 6251) for i in range(2155, 6251)])
    dms = dd.dm_grid_tol(2.0, 1000.0, 781.25e-6, freqs, tol=1.25)
    # heimdall's config yields ~1000 trials over DM 2-1000 at VLITE's
    # geometry; the adaptive grid should land in that regime
    assert 200 < len(dms) < 5000
    assert dms[0] == 2.0 and dms[-1] >= 1000.0
    # steps grow with DM (in-channel smearing loosens the tolerance)
    steps = np.diff(dms)
    assert steps[-1] > steps[0]


def test_array_streaming_mode(tmp_path):
    """Interleaved multi-antenna serving with mid-observation coincidence
    (ArrayPipeline.run_streaming): same detections + a trigger + dumps."""
    from vlite_fast.config import (AntennaConfig, ArrayConfig,
                                       TriggerConfig)
    from vlite_fast.runtime.pipeline import ArrayPipeline
    from vlite_fast.runtime.control import ObservationDocument

    cfg = PipelineConfig.tiny(freq_top_mhz=320.5, bandwidth_mhz=0.5)
    scfg = SearchConfig(dm_min=0.0, dm_max=600.0, ndm=61, gulp_samps=512,
                        boxcar_max=16, zap_ranges=(), snr_thresh=6.0)
    acfg = ArrayConfig(
        antennas=(AntennaConfig(1, "ea01"), AntennaConfig(2, "ea02")),
        pipeline=cfg, search=scfg,
        trigger=TriggerConfig(min_dm=100.0))
    ap = ArrayPipeline(acfg, out_dir=str(tmp_path))
    base_t = 1.7e9

    def seconds_for():
        s = synthesis.SynthConfig(
            tobs=2.0, dm=DM_TRUE, pulse_period=0.05, skip_period=16,
            amp=0.4, seed=21, sample_rate=cfg.sample_rate,
            freq_bot_mhz=320.0, bandwidth_mhz=0.5, buflen=250_000)
        samples, _ = synthesis.generate_baseband(s)
        return [(base_t + k,
                 samples[:, k * cfg.sample_rate:(k + 1) * cfg.sample_rate])
                for k in range(2)]

    od = ObservationDocument(name="stream", scan_no=2, start_time=base_t)
    try:
        res = ap.run_streaming({1: seconds_for(), 2: seconds_for()}, od,
                               coincide_every_s=1)
        for sid, p in res["products"].items():
            assert p.seconds == 2 and p.candidates
        assert res["triggers"], "streaming mode produced no trigger"
        assert abs(res["triggers"][0].dm - DM_TRUE) < 75
        assert res["dumps"], "streaming mode produced no dumps"
    finally:
        ap.close()


def test_no_candidates_on_pure_noise():
    cfg = PipelineConfig.tiny()
    raw = synthesis.white_noise_uint8(cfg.sample_rate, seed=31)
    state = dsp.init_state(cfg)
    out, _ = dsp.process_second(cfg, jnp.asarray(raw), state,
                                jnp.asarray(False))
    fb = search_mod.filterbank_from_packed(np.asarray(out.packed_kur),
                                           cfg.nbit, cfg.nchanout)
    freqs = cfg.freqs_mhz()
    scfg = SearchConfig(dm_min=0.0, dm_max=600.0, ndm=61, gulp_samps=256,
                        boxcar_max=8, zap_ranges=(), snr_thresh=8.0)
    eng = search_mod.SinglePulseSearch(scfg, cfg.tsamp, freqs,
                                      nsub=16, nbatch=61)
    cands = eng.search_stream(fb)
    assert len(cands) == 0


def test_search_gulp_packed_matches_unpacked():
    """The packed device-search path (bytes in, top-k out) must find the
    same candidates as the float path."""
    import numpy as np
    import jax.numpy as jnp
    from vlite_fast.config import PipelineConfig, SearchConfig
    from vlite_fast.models import baseband_dsp as dsp
    from vlite_fast.models import search as search_mod
    from vlite_fast.models import synthesis

    cfg = PipelineConfig.tiny(freq_top_mhz=320.5, bandwidth_mhz=0.5)
    s = synthesis.SynthConfig(tobs=2.0, dm=300.0, pulse_period=0.05,
                              skip_period=16, amp=0.4, seed=3,
                              sample_rate=cfg.sample_rate,
                              freq_bot_mhz=320.0, bandwidth_mhz=0.5,
                              buflen=250_000)
    samples, _ = synthesis.generate_baseband(s)
    st = dsp.init_state(cfg)
    blocks = []
    for k in range(2):
        raw = samples[:, k * cfg.sample_rate:(k + 1) * cfg.sample_rate]
        out, st = dsp.process_second(cfg, jnp.asarray(raw), st,
                                     jnp.asarray(False))
        blocks.append(np.asarray(out.packed_kur))
    packed = np.concatenate(blocks, axis=0)

    scfg = SearchConfig(dm_min=0.0, dm_max=600.0, ndm=61, gulp_samps=512,
                        boxcar_max=16, zap_ranges=(), snr_thresh=6.0,
                        dm_grid_mode="linear")
    freqs = cfg.freqs_mhz()
    eng = search_mod.SinglePulseSearch(scfg, cfg.tsamp, freqs,
                                       nsub=16, nbatch=61)
    n = scfg.gulp_samps + eng.overlap
    fb = search_mod.filterbank_from_packed(packed[:n], cfg.nbit,
                                           cfg.nchanout)
    a = eng.search_gulp(fb, t_offset=0)
    b = eng.search_gulp_packed(packed[:n], cfg.nbit, t_offset=0)
    assert len(a) == len(b) >= 1
    for ca, cb in zip(sorted(a, key=lambda c: c.peak_idx),
                      sorted(b, key=lambda c: c.peak_idx)):
        assert ca.peak_idx == cb.peak_idx and ca.dmi == cb.dmi
        assert abs(ca.snr - cb.snr) < 1e-3
