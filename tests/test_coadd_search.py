"""Multi-antenna coadd + joint search (BASELINE configs[3]): the coadded
filterbank's S/N on a common pulse must grow ~sqrt(N) over a single
antenna (the agdadacoadd purpose, SURVEY.md section 2a #18)."""

import numpy as np
import pytest
import jax.numpy as jnp

from vlite_fast.config import PipelineConfig, SearchConfig
from vlite_fast.models import baseband_dsp as dsp
from vlite_fast.models import search as search_mod
from vlite_fast.models import synthesis
from vlite_fast.models.coadd import coadd


NANT = 4
DM = 300.0


@pytest.fixture(scope="module")
def per_ant_fb():
    cfg = PipelineConfig.tiny(freq_top_mhz=320.5, bandwidth_mhz=0.5)
    fbs = []
    for k in range(NANT):
        synth = synthesis.SynthConfig(
            tobs=2.0, dm=DM, pulse_period=0.05, skip_period=16,
            amp=0.25, seed=100 + k, sample_rate=cfg.sample_rate,
            freq_bot_mhz=320.0, bandwidth_mhz=0.5, buflen=250_000)
        # same pulse phase/amplitude; independent noise via seed
        samples, info = synthesis.generate_baseband(synth)
        state = dsp.init_state(cfg)
        blocks = []
        for s in range(2):
            raw = samples[:, s * cfg.sample_rate:(s + 1) * cfg.sample_rate]
            out, state = dsp.process_second(cfg, jnp.asarray(raw), state,
                                            jnp.asarray(False))
            blocks.append(np.asarray(out.packed_kur))
        packed = np.concatenate(blocks, axis=0)
        fbs.append(search_mod.filterbank_from_packed(packed, cfg.nbit,
                                                     cfg.nchanout))
    return cfg, np.stack(fbs)


def _best_snr(cfg, fb):
    freqs = cfg.freqs_mhz()
    scfg = SearchConfig(dm_min=0.0, dm_max=600.0, ndm=61, gulp_samps=512,
                       boxcar_max=16, zap_ranges=(), snr_thresh=5.0)
    eng = search_mod.SinglePulseSearch(scfg, cfg.tsamp, freqs,
                                      nsub=16, nbatch=61)
    cands = eng.search_stream(fb.astype(np.float32))
    assert cands, "no candidates"
    return max(cands, key=lambda c: c.snr)


def test_coadd_snr_gain(per_ant_fb):
    cfg, fbs = per_ant_fb
    single = _best_snr(cfg, fbs[0])
    co = np.asarray(coadd(jnp.asarray(fbs)))
    joint = _best_snr(cfg, co)
    assert abs(joint.dm - DM) < 75
    # sqrt(4) = 2x ideal gain; allow decorrelation/quantization losses
    gain = joint.snr / single.snr
    assert gain > 1.5, f"coadd gain {gain:.2f} (single {single.snr:.1f}, " \
                       f"joint {joint.snr:.1f})"


def test_coadd_noise_stays_unit(per_ant_fb):
    cfg, fbs = per_ant_fb
    co = np.asarray(coadd(jnp.asarray(fbs)))
    # off-pulse variance ~ single-antenna variance (1/sqrt(N) scaling)
    assert 0.5 < co.std() / fbs[0].std() < 1.5
