"""Formerly-dormant diagnostics (VERDICT round-1 item 10): the block-scale
D'Agostino gate, DOHISTO sample histograms as an observation product, and
the genbase-style moments self-check."""

import numpy as np
import jax.numpy as jnp

from vlite_fast.config import PipelineConfig, SearchConfig
from vlite_fast.models import synthesis
from vlite_fast.ops import kurtosis as kur
from vlite_fast.runtime.control import ObservationDocument
from vlite_fast.runtime.pipeline import StationPipeline


def test_dag_fb_gate_zeroes_bursty_block():
    """Broadband Gaussian-amplitude-modulated RFI spread evenly over a
    whole FFT block evades many fine windows but pulls the block TS."""
    rng = np.random.default_rng(0)
    nkurto, nfft, nblk = 50, 500, 8
    x = rng.standard_normal((2, nblk * nfft)).astype(np.float32) * 0.05
    # block 3: mildly non-Gaussian everywhere (kurtosis excess spread out)
    burst = rng.standard_normal(nfft) * 0.05
    burst *= 1.0 + 2.0 * np.abs(rng.standard_normal(nfft))
    x[:, 3 * nfft:4 * nfft] = burst
    res_off = kur.rfi_excise(jnp.asarray(x), nkurto, nfft,
                             dag_fb_thresh=0.0)
    res_on = kur.rfi_excise(jnp.asarray(x), nkurto, nfft,
                            dag_fb_thresh=5.0)
    assert float(np.asarray(res_on.dag_fb)[3]) > 5.0
    # gated: block 3 fully zero-weighted and its voltages zeroed
    assert np.asarray(res_on.weights)[:, 3].max() == 0.0
    assert np.abs(np.asarray(res_on.masked)[:, 3 * nfft:4 * nfft]).max() \
        == 0.0
    # ungated keeps whatever the fine windows left
    assert np.asarray(res_off.weights)[:, 3].max() > 0.0


def test_dag_fb_gate_quiet_on_gaussian():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8 * 500)).astype(np.float32) * 0.05
    res = kur.rfi_excise(jnp.asarray(x), 50, 500, dag_fb_thresh=5.0)
    assert np.asarray(res.weights).min() > 0.5   # no wholesale flagging


def test_histogram_observation_product(tmp_path):
    cfg = PipelineConfig.tiny(do_histo=True, rfi_mode=0)
    scfg = SearchConfig.tiny()
    pipe = StationPipeline(1, cfg, scfg, out_dir=str(tmp_path),
                           keep_ring=False)
    rng = np.random.default_rng(2)
    raw = np.clip(rng.standard_normal((2, cfg.sample_rate)) / 0.05914
                  + 128.5, 0, 255).astype(np.uint8)
    od = ObservationDocument(name="H", start_time=1.6e9)
    pipe.begin_observation(od, search_live=False)
    for s in range(2):
        pipe.feed_second(1.6e9 + s, raw)
    prod = pipe.end_observation()
    import glob
    files = glob.glob(str(tmp_path / "*_histo.npz"))
    assert len(files) == 1
    h = np.load(files[0])["histogram"]
    assert h.shape == (2, 256)
    assert h.sum() == 2 * 2 * cfg.sample_rate          # every sample binned
    # roughly Gaussian around 128 (digitizer sigma ~17 counts: +-1 sigma
    # holds ~68% of samples)
    assert h[:, 111:147].sum() > 0.55 * h.sum()
    assert 120 <= h[0].argmax() <= 137
    pipe.close()


def test_synthesis_moments_check():
    s = synthesis.SynthConfig(tobs=0.5, dm=10.0, pulse_period=0.1,
                              skip_period=4, amp=0.05, seed=3,
                              sample_rate=1_000_000, freq_bot_mhz=320.0,
                              bandwidth_mhz=0.5, buflen=250_000)
    samples, info = synthesis.generate_baseband(s)
    m = info["moments"]
    assert m["ok"], m
    assert abs(m["mean"] - 128.5) < 2.0
    assert abs(m["std"] - m["expect_std"]) / m["expect_std"] < 0.05
    # a broken stream is flagged
    bad = synthesis.measure_moments(
        np.full((2, 10000), 200, np.uint8))
    assert not bad["ok"]
