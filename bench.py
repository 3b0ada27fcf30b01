"""Headline benchmark: measured full-stack antennas per card.

Times the integrated per-antenna loop end to end — device DSP chain
(unpack+kurtosis+FFT+normalize+scrunch+2-bit), drain, gulp dedispersion
search, boxcar S/N, and host candidate extraction — through
StationPipeline.feed_second with an injected FRB (ref
process_baseband.cu:1461-1481 RT margin), and reports the measured
candidate latency (ref src/trigger.py:164-166 documents 40-50 s for the
reference, gulp-bound).  Seconds are fed from host numpy arrays, as
capture hands them over.

vs_baseline: 1.0 = one antenna real-time on one card (the reference needs
one GPU per antenna); N = N antennas' full stack per card.

Needs a GPU (no fallback).  Prints the card's name and power limit, then
ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}
"""

from __future__ import annotations

import dataclasses
import json
import sys
import tempfile
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from chip_smoke import (agreement, card_line, noise_seconds,
                            search_engine_for, time_call)
    from vlite_fast import backend
    from vlite_fast import constants as Cst
    from vlite_fast.config import PipelineConfig, SearchConfig
    from vlite_fast.models import baseband_dsp as dsp
    from vlite_fast.models import search as search_mod
    from vlite_fast.runtime.control import ObservationDocument
    from vlite_fast.runtime.pipeline import StationPipeline
    from vlite_fast.utils import perf

    backend.enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench: needs a GPU; JAX found {dev.platform!r}")
    card = card_line()
    print(f"bench: card {card}", flush=True)
    peak = perf.peaks(dev.device_kind)       # unknown card: KeyError

    cfg = PipelineConfig(inject_frb=True)  # reference geometry, rfi_mode 2
    # linear 1024-trial grid for the headline; the production default is
    # the tolerance-driven grid (dm_grid_mode='tol', ~4.9k trials —
    # heimdall semantics), substituted in below as value_tolgrid
    scfg = SearchConfig(dm_grid_mode="linear")
    seconds = noise_seconds(cfg, 3, seed=0)
    staged = [jax.device_put(s, dev) for s in seconds]

    # --- DSP-chain rate: the armed program and its injection-free twin --
    arm = jax.device_put(jnp.bool_(False), dev)

    def chain_rate(c):
        carry = {"st": jax.device_put(dsp.init_state(c), dev), "i": 0}

        def one():
            o, carry["st"] = dsp.process_second(
                c, staged[carry["i"] % 3], carry["st"], arm)
            carry["i"] += 1
            return o.packed_kur, carry["st"].bp_kur
        return 1.0 / time_call(one, n=10)

    dsp_rt = chain_rate(cfg)
    cfg_off = dataclasses.replace(cfg, inject_frb=False)
    dsp_rt_gated = chain_rate(cfg_off)

    # host gating (pipeline.feed_second) is byte-exact by construction:
    # outside the armed window the injection multiplies by all-ones
    st0 = dsp.init_state(cfg)
    out_a, _ = dsp.process_second(cfg, staged[0], st0, arm)
    out_b, _ = dsp.process_second(cfg_off, staged[0], st0, arm)
    twin_agreement = agreement(np.asarray(out_a.packed_kur),
                               np.asarray(out_b.packed_kur), cfg.nbit)
    if twin_agreement != 1.0:
        raise AssertionError(
            f"injection-armed program and injection-free twin agree on "
            f"only {twin_agreement:.6f} of 2-bit levels — host gating "
            "(pipeline.feed_second) is unsound")

    # blended steady-state rate: the armed (slower) program runs
    # inject_window_seconds of every INJECT_PERIOD_S
    f_armed = dsp.inject_window_seconds(cfg) / Cst.INJECT_PERIOD_S
    dsp_rt_blended = 1.0 / (f_armed / dsp_rt
                            + (1.0 - f_armed) / dsp_rt_gated)

    # --- utilization against the card's published peaks -----------------
    dft = perf.dft_flops_per_data_second(cfg)
    chain_bytes = perf.chain_hbm_bytes_per_data_second(cfg)
    dsp_tflops = dft["hw_bf16_flops"] * dsp_rt / 1e12
    dsp_gbps = chain_bytes * dsp_rt / 1e9

    # --- dedispersion through the engine the search runs -----------------
    engine = search_mod.resolve_engine(scfg.engine)
    eng = search_engine_for(cfg, scfg)
    ntime_out = scfg.gulp_samps
    fb_gulp = jax.random.normal(jax.random.PRNGKey(1),
                                (ntime_out + eng.overlap, cfg.nchanout))
    dd_fn = jax.jit(lambda x, p: search_mod.dedisperse(engine, x, p,
                                                       ntime_out))
    dedisp_s = time_call(lambda: dd_fn(fb_gulp, eng.plan))

    # --- integrated loop: StationPipeline with live gulp search ----------
    pipe = StationPipeline(1, cfg, scfg, out_dir=tempfile.mkdtemp(),
                           keep_ring=False, write_cands=False)
    od = ObservationDocument(name="BENCH", start_time=1.7e9)
    n_sec = 40  # > one full gulp + overlap so the search runs hot
    # warm-up observation compiles every program
    pipe.begin_observation(od, write_fil=False)
    for s in range(n_sec):
        pipe.feed_second(1.7e9 + s, seconds[s % 3])
    pipe.end_observation()

    n_gulps = 0

    def _counted(orig):
        def f(*a, **k):
            nonlocal n_gulps
            n_gulps += 1
            return orig(*a, **k)
        return f
    pipe.search.search_gulp_device = _counted(pipe.search.search_gulp_device)
    pipe.search.search_gulp_packed = _counted(pipe.search.search_gulp_packed)

    pipe.begin_observation(od, write_fil=False)
    cand_latency_data = None
    t0 = time.perf_counter()
    for s in range(n_sec):
        new = pipe.feed_second(1.7e9 + s, seconds[s % 3])
        if new and cand_latency_data is None:
            cand_latency_data = pipe.metrics.get(
                "vfast_cand_latency_data_s")
    prod = pipe.end_observation()
    wall = time.perf_counter() - t0
    integrated_rt = n_sec / wall
    pipe.close()

    # --- production tol-grid number: substitute the per-gulp cost of the
    # tolerance grid for the linear one in the measured wall time --------
    def time_gulp(sps):
        eng_g = search_engine_for(cfg, sps)
        nbytes = cfg.npol_out * cfg.nchanout * cfg.nbit // 8
        full_g = sps.gulp_samps + eng_g.overlap
        pk = jax.random.randint(jax.random.PRNGKey(2), (full_g, nbytes),
                                0, 256, jnp.int32).astype(jnp.uint8)
        return time_call(lambda: eng_g.search_gulp_device(
            pk, cfg.nbit, 0, sps.gulp_samps)), len(eng_g.dms)
    gulp_lin_s, _ = time_gulp(scfg)
    gulp_tol_s, tol_trials = time_gulp(SearchConfig())
    value_tolgrid = n_sec / (wall + n_gulps * (gulp_tol_s - gulp_lin_s))

    print(json.dumps({
        "metric": "measured full-stack antennas/card (StationPipeline: "
                  "DSP + drain + dedispersion search + candidates, "
                  "injected FRB recovered)",
        "value": round(integrated_rt, 3),
        "unit": "antennas per card (x real-time, integrated loop)",
        "vs_baseline": round(integrated_rt, 3),
        "dsp_only_rt_factor": round(dsp_rt, 3),
        "dsp_only_rt_factor_gated": round(dsp_rt_gated, 3),
        "dsp_only_rt_factor_blended": round(dsp_rt_blended, 3),
        "twin_agreement": twin_agreement,
        "value_tolgrid": round(value_tolgrid, 3),
        "tolgrid_trials": tol_trials,
        "gulp_lin_s": round(gulp_lin_s, 4),
        "gulp_tol_s": round(gulp_tol_s, 4),
        "gulps_searched": n_gulps,
        "seconds_processed": n_sec,
        "wall_s": round(wall, 3),
        "candidates": len(prod.candidates),
        "best_snr": round(max((c.snr for c in prod.candidates),
                              default=0.0), 2),
        "cand_latency_data_s": cand_latency_data,
        "search_engine": engine,
        "dedisp_gulp_s": round(dedisp_s, 4),
        # shares of the card's published peaks (utils/perf.PEAKS), with
        # the power limit they were measured under
        "dsp_bf16_tflops": round(dsp_tflops, 2),
        "dsp_bf16_peak_pct": round(100 * dsp_tflops
                                   / peak["bf16_tflops"], 2),
        "dsp_hbm_gbps_min": round(dsp_gbps, 1),
        "dsp_hbm_peak_pct_min": round(100 * dsp_gbps / peak["hbm_gbps"],
                                      1),
        "peaks_source": peak["source"],
        "card": card,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
