"""Profile the integrated StationPipeline loop: where does wall time go?

Times, per fed second: dispatch (process_second call), drain fetch
(np.asarray of the previous second's packed output), host bookkeeping
(GulpStream append), and gulp search (dedispersion + top-k + candidate
fetch).  Run on a GPU; prints a breakdown table.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from vlite_fast import backend
    backend.enable_compile_cache()

    from vlite_fast.config import PipelineConfig, SearchConfig
    from vlite_fast.models import baseband_dsp as dsp
    from vlite_fast.runtime.control import ObservationDocument
    from vlite_fast.runtime.pipeline import StationPipeline

    dev = jax.devices()[0]
    cfg = PipelineConfig(inject_frb=True)
    scfg = SearchConfig(dm_grid_mode="linear")

    rng = np.random.default_rng(0)
    staged = []
    for _ in range(3):
        raw_np = np.clip(rng.standard_normal(
            (cfg.npol_in, cfg.sample_rate)) / 0.05914 + 128.5,
            0, 255).astype(np.uint8)
        staged.append(jax.device_put(raw_np, dev))

    pipe = StationPipeline(1, cfg, scfg, out_dir=tempfile.mkdtemp(),
                           keep_ring=False, write_cands=False)
    od = ObservationDocument(name="PROF", start_time=1.7e9)
    n_sec = 40

    # warmup (compiles)
    pipe.begin_observation(od, write_fil=False)
    for s in range(n_sec):
        pipe.feed_second(1.7e9 + s, staged[s % 3])
    pipe.end_observation()

    # instrument: wrap _drain and _search_ready with timers (wrapping,
    # not reimplementing — the drain's fetch policy must stay the real one)
    t_drain = [0.0]
    t_search = [0.0]
    n_gulp = [0]
    orig_drain = pipe._drain
    orig_search_ready = pipe._search_ready

    def timed_search_ready(flush=False):
        t0 = time.perf_counter()
        found = orig_search_ready(flush)
        dt = time.perf_counter() - t0
        if dt > 0.01:
            n_gulp[0] += 1
        t_search[0] += dt
        return found

    pipe._search_ready = timed_search_ready

    def timed_drain(*args):
        t0 = time.perf_counter()
        orig_drain(*args)
        t_drain[0] += time.perf_counter() - t0

    pipe._drain = timed_drain

    pipe.begin_observation(od, write_fil=False)
    t0 = time.perf_counter()
    t_dispatch = 0.0
    for s in range(n_sec):
        td = time.perf_counter()
        pipe.feed_second(1.7e9 + s, staged[s % 3])
        # feed_second includes dispatch + drain; subtract measured parts
    wall = time.perf_counter() - t0
    pipe.end_observation()
    pipe.close()

    drain_only = t_drain[0] - t_search[0]
    other = wall - t_drain[0]
    print(f"seconds={n_sec} wall={wall:.3f}s  ({n_sec/wall:.2f}x RT)")
    print(f"  drain (fetch/fil/taps):          {drain_only:.3f}s "
          f"({drain_only/n_sec*1e3:.1f} ms/s)")
    print(f"  gulp search ({n_gulp[0]} gulps):  {t_search[0]:.3f}s")
    print(f"  dispatch+host other:             {other:.3f}s "
          f"({other/n_sec*1e3:.1f} ms/s)")


if __name__ == "__main__":
    main()
