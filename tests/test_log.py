"""Observability utils: metrics registry, RT monitor, logger files."""

import os
import time

import numpy as np

from vlite_fast.utils.log import Metrics, RTMonitor, make_logger


def test_metrics_textfile(tmp_path):
    m = Metrics()
    m.set("vfast_rt_factor", 3.7, help="real-time factor")
    m.inc("vfast_seconds")
    m.inc("vfast_seconds", 2)
    out = tmp_path / "metrics.prom"
    m.write_textfile(str(out))
    text = out.read_text()
    assert "# HELP vfast_rt_factor real-time factor" in text
    assert "vfast_rt_factor 3.7" in text
    assert "vfast_seconds 3.0" in text
    assert m.get("vfast_seconds") == 3.0


def test_rt_monitor_deficit():
    rt = RTMonitor(window=2.0, tolerance=0.1)
    # pretend processing is instant: no deficit
    for _ in range(4):
        d = rt.add(1.0)
    assert rt.behind_events == 0
    assert rt.realtime_factor > 1.0


def test_rt_monitor_behind(monkeypatch):
    rt = RTMonitor(window=1.0, tolerance=0.05)
    rt._t0 = time.perf_counter() - 10.0   # simulate 10 s of wall already
    d = rt.add(1.0)
    assert d is not None and d > 8.0
    assert rt.behind_events == 1


def test_logger_file(tmp_path):
    log = make_logger("testproc", log_dir=str(tmp_path), stdout=False)
    log.info("hello world %d", 42)
    for h in log.handlers:
        h.flush()
    files = os.listdir(tmp_path)
    assert len(files) == 1
    assert "_testproc_" in files[0]
    assert "hello world 42" in (tmp_path / files[0]).read_text()


def test_sigproc_coordinate_packing():
    from vlite_fast.utils.sigproc import radians_to_sigproc
    import math
    # RA 12h30m45s = 123045.0
    ra_rad = (12 + 30 / 60 + 45 / 3600) / 24 * 2 * math.pi
    assert abs(radians_to_sigproc(ra_rad, True) - 123045.0) < 0.1
    # Dec -45d15m00s = -451500.0
    dec_rad = -(45 + 15 / 60) * math.pi / 180
    assert abs(radians_to_sigproc(dec_rad, False) - (-451500.0)) < 0.5


def test_pack_4bit_nibble_order():
    import jax.numpy as jnp
    from vlite_fast.ops.quantize import pack_bits
    # sample 0 -> low nibble, sample 1 -> high nibble
    # (ref pb_kernels.cu:693-706)
    lev = jnp.asarray(np.array([[3, 12]], np.uint8))
    assert int(np.asarray(pack_bits(lev, 4))[0, 0]) == 3 | (12 << 4)
