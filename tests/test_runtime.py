"""Host-runtime tests: ring buffer, capture assembly, control plane,
triggered dumps."""

import os
import time

import numpy as np
import pytest

from vlite_fast import constants as C
from vlite_fast.runtime.capture import SecondAssembler, replay_file
from vlite_fast.runtime.control import (Command, CommandBus,
                                            CommandClient,
                                            ObservationDocument,
                                            ScanStateMachine)
from vlite_fast.runtime.dumper import TriggeredDumper
from vlite_fast.runtime.ring import RingBuffer, FLAG_OBS_START
from vlite_fast.runtime.trigger import Trigger
from vlite_fast.utils import vdif


class TestRing:
    def test_write_read(self):
        with RingBuffer("/vfast_t_rw", bufsz=256, nbufs=4,
                        create=True) as rb:
            data = np.arange(256, dtype=np.uint8)
            assert rb.write(data, 5.0, FLAG_OBS_START) == 0
            got, ts, fl = rb.read()
            np.testing.assert_array_equal(got, data)
            assert ts == 5.0 and fl == FLAG_OBS_START
            assert rb.read() is None

    def test_full_ring_drops(self):
        with RingBuffer("/vfast_t_full", bufsz=16, nbufs=2,
                        create=True) as rb:
            d = np.zeros(16, np.uint8)
            assert rb.write(d) >= 0
            assert rb.write(d) >= 0
            assert rb.write(d) == -1
            assert rb.dropped == 1

    def test_viewer_peek(self):
        with RingBuffer("/vfast_t_peek", bufsz=16, nbufs=4,
                        create=True) as rb:
            for i in range(6):
                rb.write(np.full(16, i, np.uint8), timestamp=100.0 + i,
                         overwrite=True)
            lo, hi = rb.resident()
            assert (lo, hi) == (2, 6)
            assert rb.peek(1) is None            # overwritten
            data, ts = rb.peek(3)
            assert ts == 103.0 and data[0] == 3
            assert rb.slot_timestamp(5) == 105.0

    def test_obs_header(self):
        with RingBuffer("/vfast_t_hdr", bufsz=16, nbufs=2,
                        create=True) as rb:
            rb.set_obs_header("NAME J0534+2200\nRA 1.459")
            hdr, seq = rb.get_obs_header()
            assert "J0534" in hdr and seq == 1


class TestAssembler:
    def test_gap_fill_and_alignment(self):
        rate = 50_000  # 10 frames/s/pol
        asm = SecondAssembler(sample_rate=rate)
        fps = rate // C.VDIF_DATA_BYTES
        payload = np.full(C.VDIF_DATA_BYTES, 200, np.uint8)
        done = []
        # starts mid-second: frames before the boundary are discarded
        done += asm.feed(7, fps - 2, 0, payload)
        assert not asm._started
        for f in range(fps):
            for th in (0, 1):
                if (f, th) == (3, 0):
                    continue  # drop one frame
                done += asm.feed(8, f, th, payload)
        done += asm.feed(9, 0, 0, payload)  # next second triggers flush
        assert len(done) == 1
        sec, buf = done[0]
        assert sec == 8
        # dropped frame region is zero-filled
        lo = 3 * C.VDIF_DATA_BYTES
        assert np.all(buf[0, lo:lo + C.VDIF_DATA_BYTES] == 0)
        assert np.all(buf[1, lo:lo + C.VDIF_DATA_BYTES] == 200)
        assert np.all(buf[0, :lo] == 200)

    def test_feed_stream_roundtrip(self):
        rate = 50_000
        nsec = 2
        samples = np.random.default_rng(0).integers(
            1, 255, (2, rate * (nsec + 1)), dtype=np.uint8)
        stream = vdif.streams_to_frames(samples, ref_epoch=40,
                                        start_second=55, sample_rate=rate)
        asm = SecondAssembler(sample_rate=rate)
        done = asm.feed_stream(stream)
        assert [s for s, _ in done] == [55, 56]
        np.testing.assert_array_equal(done[0][1], samples[:, :rate])


class TestUDPCapture:
    def test_loopback_capture(self):
        import socket
        from vlite_fast.runtime.capture import UDPCapture, to_unix
        rate = 50_000
        cap = UDPCapture(port=38777, sample_rate=rate)
        try:
            samples = np.random.default_rng(4).integers(
                1, 255, (2, rate * 2), dtype=np.uint8)
            stream = vdif.streams_to_frames(samples, 40, 500,
                                            sample_rate=rate)
            tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            frames = stream.reshape(-1, C.VDIF_FRAME_BYTES)
            done = []
            for fr in frames:
                tx.sendto(fr.tobytes(), ("127.0.0.1", 38777))
            deadline = time.time() + 10
            while len(done) < 1 and time.time() < deadline:
                done.extend(cap.poll())
            assert done, "no seconds assembled from UDP frames"
            sec, buf = done[0]
            assert sec == to_unix(500, 40)
            np.testing.assert_array_equal(buf, samples[:, :rate])
            tx.close()
        finally:
            cap.close()


class TestDaemonServe:
    def test_serve_loop_with_leader(self, tmp_path):
        """Leader commands drive the daemon's serve() loop end-to-end
        (START -> file observation -> QUIT)."""
        import threading
        from vlite_fast.config import PipelineConfig, SearchConfig
        from vlite_fast.models import synthesis
        from vlite_fast.runtime.control import CommandBus, Command, \
            ObservationDocument
        from vlite_fast.runtime.station_main import StationDaemon

        cfg = PipelineConfig.tiny()
        stream, _ = synthesis.generate_vdif(
            synthesis.SynthConfig(tobs=1.0, dm=0.0, pulse_period=0.1,
                                  amp=0.0, sample_rate=cfg.sample_rate,
                                  bandwidth_mhz=0.5, buflen=250_000),
            start_second=77)
        path = tmp_path / "obs.vdif"
        stream.tofile(path)

        bus = CommandBus(port=38779)
        d = StationDaemon(9, cfg, SearchConfig.tiny(), str(tmp_path),
                          command_port=38779, coincidencer=None,
                          trigger_port=None)
        t = threading.Thread(
            target=lambda: d.serve(f"file:{path}", max_observations=1),
            daemon=True)
        t.start()
        try:
            time.sleep(0.5)
            bus.publish(Command.START,
                        ObservationDocument(name="served", scan_no=2))
            t.join(timeout=30)
            assert not t.is_alive(), "serve loop did not finish"
            fils = [f for f in os.listdir(tmp_path) if f.endswith(".fil")]
            assert fils, "no filterbank produced by served observation"
        finally:
            d.shutdown()
            bus.close()


class TestControl:
    def test_scan_state_machine(self):
        sm = ScanStateMachine()
        od1 = ObservationDocument(name="J0534+2200", ra=1.0, dec=0.5,
                                  scan_no=2)
        assert sm.feed(od1, now=0.0) == [Command.START]
        # same pointing, short integration -> keep going
        od2 = ObservationDocument(name="J0534+2200", ra=1.0 + 1e-4,
                                  dec=0.5, scan_no=3)
        assert sm.feed(od2, now=100.0) == []
        # pointing change -> STOP + START
        od3 = ObservationDocument(name="B0329+54", ra=2.0, dec=0.9,
                                  scan_no=4)
        assert sm.feed(od3, now=200.0) == [Command.STOP, Command.START]
        # integration limit forces a break even at the same pointing
        od4 = ObservationDocument(name="B0329+54", ra=2.0, dec=0.9,
                                  scan_no=5)
        assert sm.feed(od4, now=200.0 + 481) == [Command.STOP, Command.START]
        # FINISH stops
        assert sm.feed(ObservationDocument(name="FINISH"),
                       now=700.0) == [Command.STOP]
        # dummy scan 1 ignored
        assert sm.feed(ObservationDocument(name="x", scan_no=1),
                       now=800.0) == []

    def test_command_bus_tcp(self):
        bus = CommandBus(port=37555)
        try:
            cli = CommandClient(port=37555)
            time.sleep(0.3)
            od = ObservationDocument(name="J1644-4559", ra=1.2, scan_no=7)
            bus.publish(Command.START, od)
            bus.publish(Command.STOP)
            time.sleep(0.2)
            msgs = cli.poll()
            assert [m[0] for m in msgs] == [Command.START, Command.STOP]
            assert msgs[0][1].name == "J1644-4559"
            cli.close()
        finally:
            bus.close()


class TestDumper:
    def test_window_dump_and_dedup(self, tmp_path):
        with RingBuffer("/vfast_t_dump", bufsz=1024, nbufs=8,
                        create=True) as rb:
            base = 1_700_000_000.0
            for i in range(6):
                rb.write(np.full(1024, i, np.uint8), timestamp=base + i)
            d = TriggeredDumper(rb, str(tmp_path), station_id=3)
            t = Trigger(t0=base + 1.5, t1=base + 3.2, sn=10, dm=80,
                        width=0.01, peak_time=2.0)
            rec = d.dump(t)
            assert rec is not None
            assert rec.seconds == [int(base + 1), int(base + 2),
                                   int(base + 3)]
            assert rec.nbytes == 3 * 1024
            assert os.path.exists(rec.path)
            assert "_ea03_" in rec.path
            # same window again -> deduplicated
            assert d.dump(t) is None
            # overlapping later window dumps only the new second
            t2 = Trigger(t0=base + 3.5, t1=base + 4.2, sn=9, dm=80,
                         width=0.01, peak_time=4.0)
            rec2 = d.dump(t2)
            assert rec2.seconds == [int(base + 4)]


class TestDeviceGulpStream:
    """The device-side block accumulator serving padded flush windows
    (runtime/pipeline.DeviceGulpStream.window pad_to semantics)."""

    def _stream(self, blocks):
        from vlite_fast.runtime.pipeline import DeviceGulpStream
        import jax.numpy as jnp
        s = DeviceGulpStream()
        for b in blocks:
            s.append(jnp.asarray(b))
        return s

    def test_aligned_window(self):
        blocks = [np.full((10, 4), i, np.uint8) for i in range(4)]
        s = self._stream(blocks)
        w = np.asarray(s.window(10, 30))
        assert w.shape == (20, 4)
        assert (w[:10] == 1).all() and (w[10:] == 2).all()

    def test_misaligned_returns_none(self):
        s = self._stream([np.zeros((10, 4), np.uint8)] * 2)
        assert s.window(5, 15) is None

    def test_padded_flush_window(self):
        blocks = [np.full((10, 4), i + 1, np.uint8) for i in range(3)]
        s = self._stream(blocks)
        # tail of 20 rows available, pad to the steady 25-row shape
        w = np.asarray(s.window(10, 30, pad_to=25, fill=0x55))
        assert w.shape == (25, 4)
        assert (w[:10] == 2).all() and (w[10:20] == 3).all()
        assert (w[20:] == 0x55).all()

    def test_pad_noop_when_full(self):
        blocks = [np.full((10, 4), 7, np.uint8)] * 3
        s = self._stream(blocks)
        w = np.asarray(s.window(0, 30, pad_to=30, fill=0))
        assert w.shape == (30, 4) and (w == 7).all()

    def test_prune_then_window(self):
        blocks = [np.full((10, 4), i, np.uint8) for i in range(4)]
        s = self._stream(blocks)
        s.prune(20)
        assert s.window(10, 20) is None      # pruned away
        w = np.asarray(s.window(20, 40))
        assert (w[:10] == 2).all() and (w[10:] == 3).all()


def test_station_pipeline_memory_bounded():
    """Long-observation soak: the host-side gulp accumulators must stay
    O(gulp), not O(observation) (the round-1 O(T^2) drain, ADVICE.md),
    and feed_second must not slow down as the observation ages."""
    import time as _time
    import jax.numpy as jnp
    from vlite_fast.config import PipelineConfig, SearchConfig
    from vlite_fast.runtime.control import ObservationDocument
    from vlite_fast.runtime.pipeline import StationPipeline

    cfg = PipelineConfig.tiny()
    scfg = SearchConfig.tiny()
    pipe = StationPipeline(1, cfg, scfg, out_dir="/tmp/vfast_soak",
                           keep_ring=False, write_cands=False)
    rng = np.random.default_rng(0)
    raw = jnp.asarray(np.clip(rng.standard_normal(
        (2, cfg.sample_rate)) / 0.05914 + 128.5, 0, 255).astype(np.uint8))
    od = ObservationDocument(name="SOAK", start_time=1.6e9)
    pipe.begin_observation(od, write_fil=False)
    n_sec = 40
    bound = scfg.gulp_samps + pipe.search.overlap \
        + cfg.seg_per_sec * cfg.out_samps_per_seg  # one gulp + one second
    times = []
    for s in range(n_sec):
        t0 = _time.perf_counter()
        pipe.feed_second(1.6e9 + s, raw)
        times.append(_time.perf_counter() - t0)
        held = pipe._fb.total - pipe._fb.start
        held_dev = pipe._fb_dev.total - pipe._fb_dev.start
        assert held <= bound, f"host accum grew to {held} rows at s={s}"
        assert held_dev <= bound
    pipe.end_observation()
    pipe.close()
    # steady-state cost must not trend upward with observation age;
    # medians smooth over which seconds happen to complete a gulp
    early = float(np.median(times[4:16]))
    late = float(np.median(times[n_sec - 12:]))
    assert late < 5 * max(early, 1e-3), (early, late)


class TestAssemblerDuplicates:
    """ADVICE r2: duplicate / out-of-order frames must never overwrite
    already-placed payloads (first arrival wins, both feed paths)."""

    def test_feed_keeps_first_arrival(self):
        rate = 50_000
        asm = SecondAssembler(sample_rate=rate)
        good = np.full(C.VDIF_DATA_BYTES, 200, np.uint8)
        corrupt = np.zeros(C.VDIF_DATA_BYTES, np.uint8)
        fps = rate // C.VDIF_DATA_BYTES
        done = []
        done += asm.feed(8, 0, 0, good)
        done += asm.feed(8, 0, 1, good)
        done += asm.feed(8, 1, 0, good)
        done += asm.feed(8, 1, 0, corrupt)   # corrupt duplicate
        for f in range(2, fps):
            for th in (0, 1):
                done += asm.feed(8, f, th, good)
        done += asm.feed(9, 0, 0, good)
        _, buf = done[0]
        lo = C.VDIF_DATA_BYTES
        assert np.all(buf[0, lo:lo + C.VDIF_DATA_BYTES] == 200)
        assert asm.stats.anomalous >= 1

    def test_feed_stream_keeps_first_arrival(self):
        rate = 50_000
        samples = np.random.default_rng(1).integers(
            1, 255, (2, rate * 2), dtype=np.uint8)
        stream = vdif.streams_to_frames(samples, ref_epoch=40,
                                        start_second=55, sample_rate=rate)
        frames = stream.reshape(-1, C.VDIF_FRAME_BYTES)
        # duplicate frame 4 (a mid-second pol-0 frame) with zeroed payload
        dup = frames[4].copy()
        dup[C.VDIF_HEADER_BYTES:] = 0
        frames = np.concatenate([frames[:6], dup[None], frames[6:]])
        asm = SecondAssembler(sample_rate=rate)
        done = asm.feed_stream(frames.reshape(-1))
        assert [s for s, _ in done] == [55]
        np.testing.assert_array_equal(done[0][1], samples[:, :rate])
        assert asm.stats.anomalous == 1


def test_inject_host_gating_byte_exact():
    """feed_second dispatches the injection-free chain outside the ~2 s
    post-arm window (perf: the track multiply costs two extra passes over
    the spectra plane per segment).  The routed output must be BYTE-exact
    vs running the injection program unconditionally with the same arm
    schedule (outside the window it multiplies by all-ones)."""
    import jax.numpy as jnp
    from vlite_fast import constants as C
    from vlite_fast.config import PipelineConfig, SearchConfig
    from vlite_fast.models import baseband_dsp as dsp
    from vlite_fast.runtime.control import ObservationDocument
    from vlite_fast.runtime.pipeline import StationPipeline

    cfg = PipelineConfig.tiny(inject_frb=True)
    scfg = SearchConfig.tiny()
    n_sec = dsp.inject_window_seconds(cfg) + 3
    assert n_sec < C.INJECT_PERIOD_S
    rng = np.random.default_rng(7)
    secs = [np.clip(rng.standard_normal(
        (cfg.npol_in, cfg.sample_rate)) / 0.05914 + 128.5, 0,
        255).astype(np.uint8) for _ in range(n_sec)]

    pipe = StationPipeline(1, cfg, scfg, out_dir="/tmp/vfast_gate",
                           keep_ring=False, write_cands=False)
    got = []
    pipe.block_taps.append(lambda sid, off, blk: got.append(blk.copy()))
    od = ObservationDocument(name="GATE", start_time=1.6e9)
    pipe.begin_observation(od, write_fil=False)
    routed = []
    for s in range(n_sec):
        pipe.feed_second(1.6e9 + s, jnp.asarray(secs[s]))
        routed.append(pipe._nsec - 1 < pipe._inject_until)
    pipe.end_observation()
    pipe.close()
    # the fast path must actually engage after the window
    assert routed[0] and not routed[-1], routed

    # oracle: the injection program every second, same arm schedule
    st = dsp.init_state(cfg)
    want = []
    for s in range(n_sec):
        out, st = dsp.process_second(
            cfg, jnp.asarray(secs[s]), st,
            jnp.asarray(s % C.INJECT_PERIOD_S == 0))
        want.append(np.asarray(out.packed_kur if cfg.rfi_mode
                               else out.packed))
    np.testing.assert_array_equal(np.concatenate(got, axis=0),
                                  np.concatenate(want, axis=0))


def test_prewarm_compiles_both_programs():
    """begin_observation must compile BOTH the injection-armed chain and
    its injection-free twin BEFORE the first second is fed: the twin is
    first dispatched mid-observation (feed_second host gating), and a
    lazy compile there is a multi-minute real-time stall on a cold cache
    (the reference compiles its CUDA kernels at process start, not in
    the hot loop)."""
    from vlite_fast.config import PipelineConfig, SearchConfig
    from vlite_fast.models import baseband_dsp as dsp
    from vlite_fast.runtime.control import ObservationDocument
    from vlite_fast.runtime.pipeline import StationPipeline

    cfg = PipelineConfig.tiny(inject_frb=True)
    pipe = StationPipeline(1, cfg, SearchConfig.tiny(),
                           out_dir="/tmp/vfast_prewarm",
                           keep_ring=False, write_cands=False)
    dsp.process_second._clear_cache()
    assert dsp.process_second._cache_size() == 0
    pipe.begin_observation(ObservationDocument(name="W", start_time=1.6e9),
                           write_fil=False)
    # two programs (armed cfg + injection-free twin) already compiled —
    # the first feed_second can never trigger a compile of either
    assert dsp.process_second._cache_size() == 2
    rng = np.random.default_rng(3)
    buf = np.clip(rng.standard_normal(
        (cfg.npol_in, cfg.sample_rate)) / 0.05914 + 128.5, 0,
        255).astype(np.uint8)
    for s in range(2):
        pipe.feed_second(1.6e9 + s, buf)
    assert dsp.process_second._cache_size() == 2
    pipe.end_observation()
    pipe.close()

    # a second observation on the same pipeline re-warms for free
    pipe2_calls = dsp.process_second._cache_size()
    assert pipe2_calls == 2
