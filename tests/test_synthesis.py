"""Synthetic-baseband backend tests (genbase equivalent)."""

import numpy as np
import pytest

from vlite_fast.models import synthesis
from vlite_fast.utils import vdif


TINY = synthesis.SynthConfig(
    tobs=1.0, dm=0.0, pulse_period=0.05, skip_period=1, amp=0.3,
    seed=11, sample_rate=1_000_000, freq_bot_mhz=320.0, bandwidth_mhz=0.5,
    buflen=250_000)


def test_moments():
    # statistical check a la genbase measure_moments (ref genbase.cu:600-649):
    # voltages ~ N(128.5, 1/0.05914)
    cfg = synthesis.SynthConfig(**{**TINY.__dict__, "amp": 0.0})
    samples, info = synthesis.generate_baseband(cfg)
    assert samples.shape[0] == 2
    assert samples.shape[1] == cfg.tobs * cfg.sample_rate
    x = (samples.astype(np.float32) - 128.0) * 0.05914
    assert abs(x.mean()) < 0.01
    assert abs(x.std() - 1.0) < 0.02


def test_pulse_visible_at_dm0():
    samples, info = synthesis.generate_baseband(TINY)
    x = (samples[0].astype(np.float32) - 128.0) * 0.05914
    p = x ** 2
    period = info["period"]
    duty = int(period * TINY.duty_phase)
    on = np.concatenate([p[k:k + duty] for k in
                         range(0, samples.shape[1] - period, period)])
    off = np.concatenate([p[k + 2 * duty:k + 3 * duty] for k in
                          range(0, samples.shape[1] - period, period)])
    # amp 0.3 -> power ratio 1.69
    assert on.mean() / off.mean() > 1.4


def test_dispersion_delays_pulse():
    cfg = synthesis.SynthConfig(**{**TINY.__dict__, "dm": 300.0,
                                   "skip_period": 4})
    samples, info = synthesis.generate_baseband(cfg)
    assert info["n_dm_samp"] > 0
    # total smearing across 0.5 MHz at 320 MHz, DM 300:
    # dt = DM/2.41e-10 * (320^-2 - 320.5^-2) us ~ 38 ms -> ~38000 samples
    assert 30_000 < info["n_dm_samp"] < 50_000
    x = (samples.astype(np.float32) - 128.0) * 0.05914
    assert abs(x.std() - 1.0) < 0.05


def test_vdif_output():
    stream, info = synthesis.generate_vdif(TINY, ref_epoch=40,
                                           start_second=1000, station_id=5)
    back, hdr = vdif.frames_to_streams(stream)
    assert hdr.station_id == 5
    assert hdr.seconds == 1000
    assert back.shape[0] == 2
    x = (back.astype(np.float32) - 128.0) * 0.05914
    assert abs(x.std() - 1.0) < 0.05


def test_rfi_mode():
    cfg = synthesis.SynthConfig(**{**TINY.__dict__, "add_rfi": True,
                                   "amp": 0.0})
    clean = synthesis.generate_baseband(
        synthesis.SynthConfig(**{**TINY.__dict__, "amp": 0.0}))[0]
    dirty = synthesis.generate_baseband(cfg)[0]
    xc = (clean.astype(np.float32) - 128.0) * 0.05914
    xd = (dirty.astype(np.float32) - 128.0) * 0.05914
    # RFI adds ~10% duty uniform power
    assert xd.var() > xc.var() * 1.02
