"""Station daemon integration: leader commands -> replay observation ->
candidates shipped to the coincidencer -> trigger fanout -> voltage dump.
The whole multi-process topology of the reference in one test
(SURVEY.md section 4: multi-node test without the VLA, via fake ODs)."""

import os
import time

import numpy as np
import pytest

from vlite_fast.config import (PipelineConfig, SearchConfig,
                                   TriggerConfig)
from vlite_fast.models import synthesis
from vlite_fast.runtime.candidate_server import CoincidencerServer
from vlite_fast.runtime.control import Command, ObservationDocument
from vlite_fast.runtime.station_main import StationDaemon
from vlite_fast.runtime.trigger import TriggerSender
from vlite_fast.utils import vdif


@pytest.fixture(scope="module")
def synth_vdif(tmp_path_factory):
    d = tmp_path_factory.mktemp("vdif")
    cfg = synthesis.SynthConfig(
        tobs=2.0, dm=300.0, pulse_period=0.05, skip_period=16, amp=0.4,
        seed=21, sample_rate=1_000_000, freq_bot_mhz=320.0,
        bandwidth_mhz=0.5, buflen=250_000)
    stream, info = synthesis.generate_vdif(cfg, ref_epoch=40,
                                           start_second=1000, station_id=7)
    path = d / "obs.vdif"
    stream.tofile(path)
    return str(path)


def test_full_topology(synth_vdif, tmp_path):
    cfg = PipelineConfig.tiny(freq_top_mhz=320.5, bandwidth_mhz=0.5)
    scfg = SearchConfig(dm_min=0.0, dm_max=600.0, ndm=60, gulp_samps=512,
                        boxcar_max=16, zap_ranges=(), snr_thresh=6.0)
    triggers_seen = []

    # coincidencer + trigger fanout (leader side)
    tx = TriggerSender([("127.0.0.1", 37913)])

    def on_trigger(t):
        triggers_seen.append(t)
        tx.send(t)

    srv = CoincidencerServer(port=37914, tsamp=cfg.tsamp,
                             tcfg=TriggerConfig(min_dm=100.0),
                             on_trigger=on_trigger)
    daemons = []
    try:
        for sid in (1, 2):
            daemons.append(StationDaemon(
                sid, cfg, scfg, str(tmp_path / f"st{sid}"),
                command_port=None, coincidencer=("127.0.0.1", 37914),
                trigger_port=37913 if sid == 1 else None))

        from vlite_fast.runtime.capture import replay_file
        od = ObservationDocument(name="pulse", scan_no=2,
                                 start_time=0.0)
        for d in daemons:
            secs = ((s, b) for s, b, _ in
                    replay_file(synth_vdif, sample_rate=cfg.sample_rate))
            prod = d.run_observation(secs, od)
            assert prod.seconds == 2
            assert len(prod.candidates) >= 1

        deadline = time.time() + 20
        while not triggers_seen and time.time() < deadline:
            time.sleep(0.05)
        assert triggers_seen, "coincidencer produced no trigger"
        t = triggers_seen[0]
        assert abs(t.dm - 300.0) < 75.0

        # station 1's trigger listener should have dumped voltages
        deadline = time.time() + 20
        dump_dir = str(tmp_path / "st1" / "dumps")
        while time.time() < deadline:
            if os.path.isdir(dump_dir) and os.listdir(dump_dir):
                break
            time.sleep(0.1)
        files = os.listdir(dump_dir)
        assert files, "no voltage dump written"
        # the dump must settle to whole ring slots (the dumper may still
        # be writing when the directory first becomes non-empty)
        path = os.path.join(dump_dir, files[0])
        sec_bytes = cfg.npol_in * cfg.sample_rate
        deadline = time.time() + 20
        while time.time() < deadline:
            sz = os.path.getsize(path)
            if sz > 0 and sz % sec_bytes == 0:
                time.sleep(0.2)
                if os.path.getsize(path) == sz:
                    break
            time.sleep(0.1)
        raw = np.fromfile(path, np.uint8)
        assert raw.size % sec_bytes == 0 and raw.size > 0
    finally:
        for d in daemons:
            d.shutdown()
        srv.close()
        tx.close()


class _FakeCandClient:
    """Records (utc, beam, cands) batches instead of a TCP send."""
    def __init__(self):
        self.batches = []

    def send(self, utc, beam, cands):
        self.batches.append((utc, beam, list(cands)))


def test_candidates_ship_per_gulp(synth_vdif, tmp_path):
    """Candidate batches must reach the coincidencer as gulps complete
    (gulp-bound latency), not at observation end."""
    from vlite_fast.runtime.capture import replay_file
    cfg = PipelineConfig.tiny(freq_top_mhz=320.5, bandwidth_mhz=0.5)
    scfg = SearchConfig(dm_min=0.0, dm_max=600.0, ndm=60, gulp_samps=256,
                        boxcar_max=16, zap_ranges=(), snr_thresh=6.0)
    d = StationDaemon(1, cfg, scfg, str(tmp_path), command_port=None,
                      coincidencer=None, trigger_port=None)
    fake = _FakeCandClient()
    d.cands = fake
    od = ObservationDocument(name="p", scan_no=2, start_time=0.0)
    shipped_before_end = []
    orig_end = d.pipeline.end_observation

    def counting_end():
        shipped_before_end.append(len(fake.batches))
        return orig_end()

    d.pipeline.end_observation = counting_end
    try:
        secs = ((s, b) for s, b, _ in
                replay_file(synth_vdif, sample_rate=cfg.sample_rate))
        prod = d.run_observation(secs, od)
    finally:
        d.shutdown()
    assert prod.candidates
    assert fake.batches, "no candidate batches shipped"
    # at least one batch went out BEFORE the observation ended
    assert shipped_before_end[0] >= 1
    total = sum(len(b[2]) for b in fake.batches)
    assert total == len(prod.candidates)


def test_candidate_utc_rebase_across_skewed_stations(synth_vdif, tmp_path):
    """Two stations whose capture locked one second apart must land in
    the SAME coincidence group with consistent sample indices."""
    from vlite_fast.runtime.capture import replay_file
    cfg = PipelineConfig.tiny(freq_top_mhz=320.5, bandwidth_mhz=0.5)
    scfg = SearchConfig(dm_min=0.0, dm_max=600.0, ndm=60, gulp_samps=512,
                        boxcar_max=16, zap_ranges=(), snr_thresh=6.0)
    secs_all = [(s, b) for s, b, _ in
                replay_file(synth_vdif, sample_rate=cfg.sample_rate)]
    t_data0 = secs_all[0][0]
    od = ObservationDocument(name="p", scan_no=2, start_time=t_data0)
    batches = {}
    for sid, secs in ((1, secs_all), (2, secs_all[1:])):  # station 2: +1 s
        d = StationDaemon(sid, cfg, scfg, str(tmp_path / f"s{sid}"),
                          command_port=None, coincidencer=None,
                          trigger_port=None)
        fake = _FakeCandClient()
        d.cands = fake
        try:
            d.run_observation(iter(secs), od)
        finally:
            d.shutdown()
        assert fake.batches
        batches[sid] = fake.batches
    utcs = {b[0] for bs in batches.values() for b in bs}
    assert len(utcs) == 1, f"stations grouped under different utcs {utcs}"
    # station 2's indices are rebased: its first-second pulse (at data
    # second t_data0+1) must sit ~1 s of samples later than station 1's
    c1 = max((c for _, _, cs in batches[1] for c in cs),
             key=lambda c: c.snr)
    c2 = max((c for _, _, cs in batches[2] for c in cs),
             key=lambda c: c.snr)
    rate_samps = round(1.0 / cfg.tsamp)
    # the same pulse train: peaks align modulo the pulse period, and
    # station 2's absolute indices are >= one second in
    assert c2.i0 >= rate_samps // 2
    assert abs((c2.peak_time - c1.peak_time) % 0.8) < 0.05 or \
           abs(0.8 - (c2.peak_time - c1.peak_time) % 0.8) < 0.05


def test_deferred_start_after_stop_batch(synth_vdif, tmp_path):
    """A STOP and the next START arriving in ONE command batch must not
    lose the START (the repointing cascade)."""
    cfg = PipelineConfig.tiny(freq_top_mhz=320.5, bandwidth_mhz=0.5)
    scfg = SearchConfig.tiny()
    d = StationDaemon(1, cfg, scfg, str(tmp_path), command_port=None,
                      coincidencer=None, trigger_port=None)
    od2 = ObservationDocument(name="scan2", scan_no=3, start_time=0.0)
    # simulate the tail of a mid-observation poll batch: the START that
    # followed a STOP was deferred
    d._pending_cmds = [(Command.START, od2)]
    try:
        d.serve(f"file:{synth_vdif}", poll_s=0.01, max_observations=1)
    finally:
        d.shutdown()
    # the deferred START ran an observation (a .fil was produced)
    import glob
    assert glob.glob(str(tmp_path / "*.fil"))


def test_search_live_false_keeps_nothing(tmp_path):
    """search_live=False must not accumulate device or host gulp blocks
    (no search will consume/prune them)."""
    import jax.numpy as jnp
    from vlite_fast.runtime.pipeline import StationPipeline
    cfg = PipelineConfig.tiny()
    pipe = StationPipeline(1, cfg, SearchConfig.tiny(),
                           out_dir=str(tmp_path), keep_ring=False)
    od = ObservationDocument(name="rec", start_time=1.6e9)
    raw = synthesis.white_noise_uint8(cfg.sample_rate, seed=1)
    pipe.begin_observation(od, write_fil=True, search_live=False)
    for s in range(4):
        pipe.feed_second(1.6e9 + s, jnp.asarray(raw))
    prod = pipe.end_observation()
    pipe.close()
    assert prod.seconds == 4 and prod.fil_path
    assert not pipe._fb_dev.blocks and not pipe._fb.blocks
    assert prod.candidates == []
