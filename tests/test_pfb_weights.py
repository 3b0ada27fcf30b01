"""Kurtosis-weighted PFB channelizer (VERDICT round-1 item 8): the WOLA
weight bookkeeping lets channelizer='pfb' run with rfi_mode 1/2."""

import numpy as np
import jax.numpy as jnp

from vlite_fast.config import PipelineConfig
from vlite_fast.models import baseband_dsp as dsp
from vlite_fast.ops import channelize as ch
from vlite_fast.ops import kurtosis as kur


def test_pfb_weights_energy_average():
    """Per-spectrum weight = tap-energy-weighted mean of the contributing
    blocks' surviving fractions; clean blocks stay at 1."""
    ntap, nfft, nblk = 4, 500, 8
    w_blk = np.ones((2, nblk + ntap - 1), np.float32)
    w_blk[:, 4] = 0.0          # one dead block (index 4 in extended frame)
    w = np.asarray(ch.pfb_weights(jnp.asarray(w_blk), ntap, nfft))
    assert w.shape == (2, nblk)
    win = ch._pfb_window(ntap, nfft)
    e = (win.reshape(ntap, nfft) ** 2).sum(axis=1)
    e = e / e.sum()
    # spectrum j draws extended blocks j..j+ntap-1: spectra 1..4 touch
    # dead block 4 via tap (4 - j)
    for j in range(nblk):
        expect = 1.0 - (e[4 - j] if 1 <= 4 - j <= ntap - 1 or 4 - j == 0
                        else 0.0) * (1.0 if 0 <= 4 - j < ntap else 0.0)
        assert abs(w[0, j] - expect) < 1e-6, (j, w[0, j], expect)
    # all-clean input stays exactly 1
    w1 = np.asarray(ch.pfb_weights(jnp.ones((1, nblk + ntap - 1)),
                                   ntap, nfft))
    np.testing.assert_allclose(w1, 1.0, atol=1e-6)


def test_pfb_chain_with_rfi_mode2_runs_and_flags():
    """The full dual-stream chain with the PFB channelizer: clean data
    keeps weights ~1; an injected impulsive RFI burst drops the WOLA
    weights of the spectra whose taps touch it."""
    cfg = PipelineConfig.tiny(channelizer="pfb", rfi_mode=2)
    rng = np.random.default_rng(0)
    raw = np.clip(rng.standard_normal((2, cfg.sample_rate)) / 0.05914
                  + 128.5, 0, 255).astype(np.uint8)
    st = dsp.init_state(cfg)
    assert st.tail.shape == (2, 2, (cfg.pfb_ntap - 1) * cfg.nfft)
    assert st.wtail.shape == (2, cfg.pfb_ntap - 1)
    out, st = dsp.process_second(cfg, jnp.asarray(raw), st,
                                 jnp.asarray(False))
    w_clean = np.asarray(out.weights)
    assert w_clean.min() > 0.8

    # burst in segment 3, block 5: impulsive spikes across a whole block
    raw2 = raw.copy()
    seg, blk = 3, 5
    lo = seg * cfg.seg_samps + blk * cfg.nfft
    raw2[:, lo:lo + cfg.nfft:7] = 255
    out2, st = dsp.process_second(cfg, jnp.asarray(raw2), st,
                                  jnp.asarray(False))
    w = np.asarray(out2.weights)
    # spectra j = hit .. hit+ntap-1 touch the dead block; the deep dips
    # are at the CENTER taps (sinc-hamming tap energies ~[.002,.498,.498,
    # .002]), i.e. spectra hit+1 and hit+2
    hit = seg * cfg.ffts_per_seg + blk
    assert w[:, hit + 1].max() < 0.6
    assert w[:, hit + 2].max() < 0.6
    assert w[:, hit + cfg.pfb_ntap:hit + cfg.pfb_ntap + 1].min() > 0.9
    # the packed kur stream is produced (nonempty) and differs from plain
    assert np.asarray(out2.packed_kur).size > 0


def test_pfb_weights_thread_across_segments():
    """A dead block at a segment's END must depress the FIRST spectra of
    the next segment through the carried wtail."""
    cfg = PipelineConfig.tiny(channelizer="pfb", rfi_mode=2)
    rng = np.random.default_rng(1)
    raw = np.clip(rng.standard_normal((2, cfg.sample_rate)) / 0.05914
                  + 128.5, 0, 255).astype(np.uint8)
    # burst in the LAST block of segment 0
    blk = cfg.ffts_per_seg - 1
    lo = blk * cfg.nfft
    raw[:, lo:lo + cfg.nfft:7] = 255
    st = dsp.init_state(cfg)
    out, st = dsp.process_second(cfg, jnp.asarray(raw), st,
                                 jnp.asarray(False))
    w = np.asarray(out.weights)
    first_of_seg1 = cfg.ffts_per_seg
    # the dead block (last of segment 0) hits the FIRST spectra of
    # segment 1 through the carried wtail, at the center-tap energies
    assert w[0, first_of_seg1] < 0.6
    assert w[0, first_of_seg1 + 1] < 0.6
    assert w[0, blk] > 0.99                   # its own tap-3 energy ~0.002
    assert w[0, first_of_seg1 + cfg.pfb_ntap] > 0.9   # past the taps