#!/usr/bin/env python3
"""Bring-up check of the station pipeline on one GPU.

Drives the per-antenna StationPipeline at the full production geometry
(128 Msamp/s, 2 pols, NFFT 12500, 4096 channels, rfi_mode 2, 2-bit out;
tolerance DM grid 2-1000, 12 s gulps, boxcars to 64) in ONE process:

  1. device     the card's name and power limit; refuses anything but a GPU
  2. compile    the chain's armed and injection-free per-second programs and
                the gulp search program: compile seconds, memory_analysis
  3. chain      2 data-seconds through the default chain on the card against
                the CPU chain at dft_precision='highest' (>= 0.99998 of
                2-bit levels equal), and what Precision.HIGH lowers to
  4. dedisp     the platform's engine against the XLA gather engine and the
                numpy reference on one production gulp
  5. timings    dedispersion per gulp (kernel, subband, fourier), search
                stages, chain ms per data-second (matmul vs fft, 320 vs 10
                segments per second) — findings, not gates
  6. e2e        40 host-fed data-seconds through StationPipeline: the
                injected FRB (DM 80) recovered within 2 trials at S/N >= 15

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
Any failed phase exits non-zero before it.  Details go to
chiprun_out/chip_smoke.json.

--four-cards runs only the sharded array step (8 antennas, production
geometry, 20 s call, mesh ant 2 x time 2) on four GPUs and what it is
compared with: every beam and the coadd must recover the burst within 4 DM
trials, and beam 0's bytes must agree with the one-card chain.

Usage:  python chip_smoke.py [--four-cards] [--seed N]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from vlite_fast import backend
from vlite_fast import constants as C
from vlite_fast.config import (AntennaConfig, ArrayConfig, PipelineConfig,
                               SearchConfig)
from vlite_fast.models import baseband_dsp as dsp
from vlite_fast.models import search as search_mod
from vlite_fast.ops import dedisperse as dd
from vlite_fast.ops import quantize as q_ops
from vlite_fast.parallel.mesh import make_mesh
from vlite_fast.parallel.sharded_pipeline import (build_array_step,
                                                  extract_candidates)
from vlite_fast.runtime.control import ObservationDocument
from vlite_fast.runtime.pipeline import StationPipeline

PARITY_BAR = 0.99998        # 2-bit level agreement (the 'high' DFT's bar)
DEDISP_RMS_TOL = 1e-6       # max |engine - subband| over the plane's rms
E2E_DM_TRIALS = 2           # FRB within this many DM trials of INJECT_DM
E2E_MIN_SNR = 15.0
ARRAY_DM_TRIALS = 4


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """nvidia-smi's name and power limit of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_call(fn, n: int = 3, warmup: int = 1) -> float:
    """Mean seconds per call of fn(), every call ended by
    block_until_ready, after warm-up calls (compilation)."""
    for _ in range(warmup):
        jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(n):
        jax.block_until_ready(fn())
    return (time.perf_counter() - t0) / n


def levels(packed: np.ndarray, nbit: int) -> np.ndarray:
    """Packed filterbank bytes -> quantizer levels (host side)."""
    packed = np.asarray(packed, np.uint8)
    if nbit == 8:
        return packed
    shifts = np.arange(8 // nbit, dtype=np.uint8) * nbit
    return (packed[..., None] >> shifts) & np.uint8((1 << nbit) - 1)


def agreement(a, b, nbit: int) -> float:
    return float(np.mean(levels(a, nbit) == levels(b, nbit)))


def noise_seconds(cfg, n: int, seed: int):
    """n distinct seconds of 8-bit Gaussian voltages at the quantizer's
    operating point, made on the default device in bulk and returned as
    host numpy arrays (as capture hands them over)."""
    @jax.jit
    def one(key):
        x = jax.random.normal(key, (cfg.npol_in, cfg.sample_rate),
                             jnp.float32)
        return jnp.clip(x / 0.05914 + 128.5, 0, 255).astype(jnp.uint8)

    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return [np.asarray(one(k)) for k in keys]


def search_engine_for(cfg, scfg):
    """The search object exactly as StationPipeline builds it."""
    return search_mod.SinglePulseSearch(
        scfg, cfg.tsamp, cfg.freqs_mhz(), nsub=min(128, cfg.nchanout),
        nbatch=min(scfg.ndm, 128))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def _memory(compiled) -> dict:
    m = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return {k: int(getattr(m, k)) for k in keys if hasattr(m, k)}


def phase_compile(cfg, scfg) -> dict:
    """Lower and compile the chain's per-second programs and the gulp
    search program at this geometry."""
    out = {}
    raw = jax.ShapeDtypeStruct((cfg.npol_in, cfg.sample_rate), jnp.uint8)
    progs = {"chain_armed": cfg,
             "chain_twin": dataclasses.replace(cfg, inject_frb=False)}
    for name, c in progs.items():
        t0 = time.perf_counter()
        comp = dsp.process_second.lower(c, raw, dsp.init_state(c),
                                        jnp.bool_(False)).compile()
        out[name] = {"compile_s": time.perf_counter() - t0,
                     "memory": _memory(comp)}
    eng = search_engine_for(cfg, scfg)
    nbytes = cfg.npol_out * cfg.nchanout * cfg.nbit // 8
    full = scfg.gulp_samps + eng.overlap
    k = scfg.topk or min(16 * scfg.max_candidates, 20000)
    t0 = time.perf_counter()
    comp = search_mod._device_gulp.lower(
        jax.ShapeDtypeStruct((full, nbytes), jnp.uint8), eng.plan,
        engine=search_mod.resolve_engine(scfg.engine), widths=eng.widths,
        k=k, nbit=cfg.nbit, nchan=cfg.nchanout, nbands=eng.nbands,
        thresh=float(scfg.snr_thresh)).compile()
    out["gulp_search"] = {"compile_s": time.perf_counter() - t0,
                          "memory": _memory(comp),
                          "engine": search_mod.resolve_engine(scfg.engine),
                          "ndm": len(eng.dms), "rows": full}
    return out


def run_chain(cfg, seconds, device) -> list:
    """Feed host seconds through process_second on `device` from a fresh
    state; returns [(packed, packed_kur)] per second as host arrays."""
    st = jax.device_put(dsp.init_state(cfg), device)
    outs = []
    for raw in seconds:
        o, st = dsp.process_second(cfg, jax.device_put(raw, device), st,
                                   jax.device_put(jnp.bool_(False), device))
        outs.append((np.asarray(o.packed), np.asarray(o.packed_kur)))
    return outs


def chain_agreement(outs, ref, nbit: int) -> float:
    a = np.concatenate([np.concatenate(o) for o in outs])
    b = np.concatenate([np.concatenate(o) for o in ref])
    return agreement(a, b, nbit)


def precision_high_lowering(device) -> dict:
    """Which dot algorithm Precision.HIGH runs on `device`: the bits of
    a HIGH float32 product compared with explicit algorithm presets."""
    kx, ky = jax.random.split(jax.random.PRNGKey(7))
    x = jax.device_put(jax.random.normal(kx, (512, 1024)), device)
    y = jax.device_put(jax.random.normal(ky, (1024, 512)), device)
    exact = np.asarray(x, np.float64) @ np.asarray(y, np.float64)

    def rel(r):
        return float(np.max(np.abs(np.asarray(r, np.float64) - exact))
                     / np.max(np.abs(exact)))

    high = jax.jit(lambda a, b: jnp.dot(
        a, b, precision=jax.lax.Precision.HIGH))(x, y)
    res = {"high_rel_err": rel(high), "matches": []}
    presets = jax.lax.DotAlgorithmPreset
    for name in ("TF32_TF32_F32", "BF16_BF16_F32_X3", "BF16_BF16_F32_X6",
                 "F32_F32_F32"):
        try:
            r = jax.jit(lambda a, b, p=getattr(presets, name): jnp.dot(
                a, b, precision=p, preferred_element_type=jnp.float32))(
                    x, y)
        except Exception as exc:      # not every preset exists everywhere
            res[name] = f"unsupported ({type(exc).__name__})"
            continue
        res[name] = rel(r)
        if np.array_equal(np.asarray(r), np.asarray(high)):
            res["matches"].append(name)
    errs = {k: v for k, v in res.items() if isinstance(v, float)
            and k != "high_rel_err" and v > 0}
    # the preset whose error is closest (in log) to HIGH's own
    res["nearest"] = min(errs, key=lambda k: abs(
        np.log(errs[k]) - np.log(max(res["high_rel_err"], 1e-30))))
    return res


def phase_chain_parity(cfg, seconds, device, cpu) -> dict:
    """The default chain on `device` against the CPU chain at 'highest'."""
    oracle_cfg = dataclasses.replace(cfg, dft_precision="highest")
    ref = run_chain(oracle_cfg, seconds, cpu)
    got = run_chain(cfg, seconds, device)
    return {"agreement": chain_agreement(got, ref, cfg.nbit),
            "precision_high": precision_high_lowering(device),
            "oracle": ref}


def phase_dedisp_parity(cfg, scfg, device, seed: int,
                        n_ref: int = 32) -> dict:
    """One production gulp through the platform's engine, the XLA gather
    engine and (on n_ref trials spread over the grid) the numpy
    reference.  The gulp's values are multiples of 2^-6, so every partial
    sum is exact in float32: any add order gives the same bits, and the
    comparisons test the shifts alone."""
    eng = search_engine_for(cfg, scfg)
    plan = eng.plan
    eff = plan.effective_delays()
    ntime_out = scfg.gulp_samps
    ntime = ntime_out + max(plan.max_delay, int(eff.max()))
    key = jax.random.PRNGKey(seed)
    fb = jax.device_put(jnp.round(64.0 * jax.random.normal(
        key, (ntime, cfg.nchanout))) / 64.0, device)
    engine = search_mod.resolve_engine(scfg.engine)
    got = search_mod.dedisperse(engine, fb, plan, ntime_out)
    ref = dd.dedisperse(fb, plan, ntime_out)
    got_h, ref_h = np.asarray(got), np.asarray(ref)
    rms = float(np.sqrt(np.mean(ref_h.astype(np.float64) ** 2)))
    res = {"engine": engine, "ndm": len(eng.dms), "rms": rms,
           "max_abs_vs_subband": float(np.max(np.abs(got_h - ref_h)))}
    res["vs_subband_over_rms"] = res["max_abs_vs_subband"] / rms
    pick = np.unique(np.linspace(0, len(eng.dms) - 1, n_ref).astype(int))
    fb_h = np.asarray(fb)
    oracle = dd.dedisperse_reference(fb_h, eff[pick], ntime_out,
                                     chan_weights=np.asarray(
                                         plan.chan_weights))
    res["ref_trials"] = int(len(pick))
    res["max_abs_vs_reference"] = float(np.max(np.abs(got_h[pick]
                                                      - oracle)))
    # plain float32 noise: the engines' add orders differ, so this is
    # reorder rounding only (reported, not gated)
    fbf = jax.device_put(jax.random.normal(key, (ntime, cfg.nchanout)),
                         device)
    a = np.asarray(search_mod.dedisperse(engine, fbf, plan, ntime_out))
    b = np.asarray(dd.dedisperse(fbf, plan, ntime_out))
    res["float_noise_vs_subband_over_rms"] = float(
        np.max(np.abs(a - b)) / np.sqrt(np.mean(b.astype(np.float64) ** 2)))
    res["ok"] = (res["vs_subband_over_rms"] <= DEDISP_RMS_TOL
                 and res["max_abs_vs_reference"] <= DEDISP_RMS_TOL * rms)
    return res


def phase_timings(cfg, scfg, seconds, oracle, device, engines,
                  seg_variants=(320, 10)) -> dict:
    """Per-gulp dedispersion per engine, the gulp program's stages, and
    the chain's ms per data-second per channelizer and tiling."""
    res = {"dedisp_s_per_gulp": {}, "search_stage_s": {}, "chain": {}}
    eng = search_engine_for(cfg, scfg)
    plan = eng.plan
    full = scfg.gulp_samps + eng.overlap
    ntime_out = full - plan.max_delay
    nbytes = cfg.npol_out * cfg.nchanout * cfg.nbit // 8
    key = jax.random.PRNGKey(11)
    packed = jax.device_put(jax.random.randint(
        key, (full, nbytes), 0, 256, jnp.int32).astype(jnp.uint8), device)
    deq = jax.jit(lambda p: q_ops.dequantize(p, cfg.nbit).reshape(
        full, -1)[:, :cfg.nchanout])
    fb = jax.block_until_ready(deq(packed))
    for name in engines:
        fn = jax.jit(lambda x, p, e=name: search_mod.dedisperse(
            e, x, p, ntime_out))
        res["dedisp_s_per_gulp"][name] = time_call(lambda: fn(fb, plan))

    # the gulp program's stages, each jitted alone
    engine = search_mod.resolve_engine(scfg.engine)
    dmt = jax.block_until_ready(jax.jit(lambda x, p: search_mod.dedisperse(
        engine, x, p, ntime_out))(fb, plan))
    box = jax.jit(lambda d: dd.boxcar_snr(d, plan.nchan_eff, eng.widths))
    snr = jax.block_until_ready(box(dmt))
    k = scfg.topk or min(16 * scfg.max_candidates, 20000)
    topk = jax.jit(lambda s: search_mod.pack_topk_banded(
        s, k, eng.nbands, float(scfg.snr_thresh)))
    res["search_stage_s"]["dequantize"] = time_call(lambda: deq(packed))
    res["search_stage_s"]["boxcar"] = time_call(lambda: box(dmt))
    res["search_stage_s"]["topk"] = time_call(lambda: topk(snr))
    res["search_stage_s"]["gulp_program"] = time_call(
        lambda: search_mod._device_gulp(
            packed, plan, engine=engine, widths=eng.widths, k=k,
            nbit=cfg.nbit, nchan=cfg.nchanout, nbands=eng.nbands,
            thresh=float(scfg.snr_thresh)))
    del snr, dmt

    # chain: device-resident seconds so the chain alone is timed
    raws = [jax.device_put(r, device) for r in seconds]
    seg_a, seg_b = seg_variants
    variants = {
        f"matmul_seg{seg_a}": dataclasses.replace(
            cfg, channelizer="matmul", seg_per_sec=seg_a),
        f"fft_seg{seg_a}": dataclasses.replace(
            cfg, channelizer="fft", seg_per_sec=seg_a),
        f"matmul_seg{seg_b}": dataclasses.replace(
            cfg, channelizer="matmul", seg_per_sec=seg_b)}
    arm = jax.device_put(jnp.bool_(False), device)
    for name, c in variants.items():
        carry = {"st": jax.device_put(dsp.init_state(c), device), "i": 0}

        def one_second(c=c, carry=carry):
            raw = raws[carry["i"] % len(raws)]
            o, carry["st"] = dsp.process_second(c, raw, carry["st"], arm)
            carry["i"] += 1
            return o.packed_kur, carry["st"].bp_kur

        ms = 1e3 * time_call(one_second, n=2 * len(raws))
        outs = run_chain(c, seconds[:len(oracle)], device)
        res["chain"][name] = {"ms_per_data_second": ms,
                              "agreement_vs_oracle": chain_agreement(
                                  outs, oracle, cfg.nbit)}
    return res


def phase_end_to_end(cfg, scfg, seconds, nsec: int) -> dict:
    """nsec host-fed data-seconds through StationPipeline with the FRB
    injection armed at second 0."""
    out_dir = tempfile.mkdtemp(prefix="vfast_smoke_")
    try:
        pipe = StationPipeline(1, cfg, scfg, out_dir=out_dir,
                               keep_ring=False, write_cands=False)
        search = pipe.search
        # compile the gulp program before the clock starts
        nbytes = cfg.npol_out * cfg.nchanout * cfg.nbit // 8
        full = scfg.gulp_samps + search.overlap
        search.search_gulp_device(jnp.zeros((full, nbytes), jnp.uint8),
                                  cfg.nbit, 0, scfg.gulp_samps)
        n_gulps = [0]
        for meth in ("search_gulp_device", "search_gulp_packed"):
            orig = getattr(search, meth)

            def counted(*a, _orig=orig, **k):
                n_gulps[0] += 1
                return _orig(*a, **k)
            setattr(search, meth, counted)
        od = ObservationDocument(name="SMOKE", start_time=1.7e9)
        pipe.begin_observation(od, write_fil=False)   # compiles the chain
        t0 = time.perf_counter()
        for s in range(nsec):
            pipe.feed_second(1.7e9 + s, seconds[s % len(seconds)])
        prod = pipe.end_observation()
        wall = time.perf_counter() - t0
        pipe.close()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    dms = np.asarray(search.dms)
    i_true = int(np.argmin(np.abs(dms - C.INJECT_DM)))
    near = [c for c in prod.candidates
            if abs(c.dmi - i_true) <= E2E_DM_TRIALS]
    best = max(near, key=lambda c: c.snr) if near else None
    stats = jax.devices()[0].memory_stats() or {}
    res = {"data_seconds": nsec, "wall_s": wall,
           "antennas_per_card": nsec / wall,
           "gulps_searched": n_gulps[0],
           "candidates": len(prod.candidates),
           "cand_latency_data_s": pipe.metrics.get(
               "vfast_cand_latency_data_s"),
           "inject_dm": C.INJECT_DM, "nearest_trial_dm": float(dms[i_true]),
           "best": None if best is None else {
               "snr": float(best.snr), "dm": float(best.dm),
               "dmi_offset": int(best.dmi - i_true),
               "peak_time_s": float(best.peak_time)},
           "peak_bytes_in_use": stats.get("peak_bytes_in_use")}
    res["ok"] = best is not None and best.snr >= E2E_MIN_SNR
    return res


def result_line(dev: dict) -> str:
    """The last line: the device as JAX reports it."""
    return json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}})


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def four_cards(cfg, scfg, nant: int, nsec: int, seed: int,
               inject_sec: int = 2) -> dict:
    """The sharded array step on an (ant 2 x time 2) mesh against the
    one-card chain on beam 0."""
    mesh = make_mesh(n_ant=2, n_time=2)
    acfg = ArrayConfig(antennas=tuple(AntennaConfig(i + 1, f"ea{i + 1:02d}")
                                      for i in range(nant)),
                       pipeline=cfg, search=scfg, mesh_ant=2, mesh_time=2)
    t0 = time.perf_counter()
    step_fn, _, plan, info = build_array_step(acfg, mesh, nsec_per_call=nsec,
                                              inject_sec=inject_sec)
    sh = NamedSharding(mesh, P(("ant", "time")))
    nsamp = nsec * cfg.sample_rate

    m = nant // 4

    def make_shard(key):
        # each device draws its own antennas' seconds one at a time (a
        # whole call in float32 would not fit) into its uint8 block
        dev = jax.lax.axis_index("ant") * 2 + jax.lax.axis_index("time")

        def body(i, buf):
            a, s = i // nsec, i % nsec
            k = jax.random.fold_in(jax.random.fold_in(key, dev * m + a), s)
            x = jax.random.normal(k, (cfg.npol_in, cfg.sample_rate),
                                  jnp.float32)
            u = jnp.clip(x / 0.05914 + 128.5, 0, 255).astype(jnp.uint8)
            # indexed by second: a flat sample offset overflows int32
            return jax.lax.dynamic_update_slice(buf, u[None, :, None],
                                                (a, 0, s, 0))

        buf = jnp.zeros((m, cfg.npol_in, nsec, cfg.sample_rate), jnp.uint8)
        buf = jax.lax.fori_loop(0, m * nsec, body, buf)
        return buf.reshape(m, cfg.npol_in, nsamp)

    raw = jax.jit(jax.shard_map(make_shard, mesh=mesh, in_specs=P(),
                                out_specs=P(("ant", "time")),
                                check_vma=False))(
        jax.random.PRNGKey(seed))
    nbytes = cfg.npol_out * cfg.nchanout * cfg.nbit // 8
    bp = jax.device_put(jnp.zeros((nant, cfg.npol_in, cfg.nchan),
                                  jnp.float32), sh)
    tail = jax.jit(lambda k: jax.random.randint(
        k, (nant, info.halo, nbytes), 0, 256, jnp.int32).astype(jnp.uint8),
        out_shardings=sh)(jax.random.PRNGKey(seed + 1))
    out, _ = step_fn(raw, bp, bp, tail)
    jax.block_until_ready(out)
    t_first = time.perf_counter() - t0
    t1 = time.perf_counter()
    out, _ = step_fn(raw, bp, bp, tail)
    jax.block_until_ready(out)
    t_step = time.perf_counter() - t1
    per_beam, coadd, stats = extract_candidates(out, info, scfg)

    dms = np.asarray(info.dms)
    i_true = int(np.argmin(np.abs(dms - cfg.inject_dm)))
    beams = {}
    ok = True
    for b in range(nant):
        near = [c for c in per_beam.get(b, [])
                if abs(c.dmi - i_true) <= ARRAY_DM_TRIALS]
        best = max(near, key=lambda c: c.snr) if near else None
        beams[b] = None if best is None else {
            "snr": float(best.snr), "dmi_offset": int(best.dmi - i_true)}
        ok &= best is not None
    near = [c for c in coadd if abs(c.dmi - i_true) <= ARRAY_DM_TRIALS]
    cbest = max(near, key=lambda c: c.snr) if near else None
    ok &= cbest is not None

    # beam 0 through the one-card chain on the same seconds
    shard0 = next(s for s in raw.addressable_shards
                  if s.index[0].start in (0, None))
    beam0 = shard0.data[0]
    dev0 = shard0.device
    # by second index: a flat sample offset overflows int32 past 16 s
    take_sec = jax.jit(lambda b, s: jax.lax.dynamic_index_in_dim(
        b.reshape(cfg.npol_in, nsec, cfg.sample_rate), s, axis=1,
        keepdims=False))
    st = jax.device_put(dsp.init_state(cfg), dev0)
    ref = []
    for s in range(nsec):
        o, st = dsp.process_second(
            cfg, take_sec(beam0, s), st,
            jax.device_put(jnp.bool_(s == inject_sec), dev0))
        ref.append(np.asarray(o.packed_kur if cfg.rfi_mode else o.packed))
    agree = agreement(np.asarray(out.packed_kur[0]), np.concatenate(ref),
                      cfg.nbit)
    ok &= agree >= PARITY_BAR
    return {"mesh": {"ant": 2, "time": 2}, "nant": nant, "nsec": nsec,
            "ndm": len(dms), "first_call_s": t_first, "step_s": t_step,
            "antenna_seconds_per_s": nant * nsec / t_step,
            "beams": beams, "coadd": None if cbest is None else {
                "snr": float(cbest.snr),
                "dmi_offset": int(cbest.dmi - i_true)},
            "topk_stats": stats, "beam0_agreement": agree, "ok": bool(ok)}


# ---------------------------------------------------------------------------

def _save(report: dict) -> None:
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as fp:
        json.dump(report, fp, indent=1, default=str)


def _fail(report: dict, msg: str) -> None:
    report["failed"] = msg
    _save(report)
    sys.exit(f"chip_smoke: FAILED: {msg}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded array step on four GPUs")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)


    dev = phase_device()
    if dev["platform"] != "gpu":
        sys.exit(f"chip_smoke: needs a GPU; JAX found {dev['platform']!r} "
                 "(no fallback)")
    backend.enable_compile_cache()
    report = {"device": dev, "card": card_line()}
    log(report["card"])     # nvidia-smi's own line: name, power limit
    log(f"[device] jax: platform={dev['platform']} kind={dev['kind']!r} "
        f"count={dev['count']}")
    cfg = PipelineConfig(inject_frb=True)
    scfg = SearchConfig()

    if args.four_cards:
        if dev["count"] != 4:
            sys.exit(f"chip_smoke: --four-cards needs 4 GPUs, found "
                     f"{dev['count']}")
        res = four_cards(cfg, scfg, nant=8, nsec=20, seed=args.seed)
        report["four_cards"] = res
        log(f"[four-cards] {json.dumps(res, default=str)}")
        if not res["ok"]:
            _fail(report, "four-card array step")
        _save(report)
        log(result_line(dev))
        return

    gpu = jax.devices()[0]
    cpu = jax.devices("cpu")[0]
    t_all = time.perf_counter()

    res = phase_compile(cfg, scfg)
    report["compile"] = res
    for name, r in res.items():
        log(f"[compile] {name}: {r['compile_s']:.1f} s, memory "
            f"{r['memory']}")

    seconds = noise_seconds(cfg, 8, args.seed)
    chain_cfg = dataclasses.replace(cfg, inject_frb=False)
    res = phase_chain_parity(chain_cfg, seconds[:2], gpu, cpu)
    oracle = res.pop("oracle")
    report["chain_parity"] = res
    log(f"[chain] 2-bit agreement vs CPU 'highest' oracle: "
        f"{res['agreement']:.7f} (bar {PARITY_BAR})")
    log(f"[chain] Precision.HIGH on this card: {res['precision_high']}")
    if res["agreement"] < PARITY_BAR:
        _fail(report, "chain parity")

    res = phase_dedisp_parity(cfg, scfg, gpu, args.seed)
    report["dedisp_parity"] = res
    log(f"[dedisp] {json.dumps(res)}")
    if not res["ok"]:
        _fail(report, "dedispersion parity")

    res = phase_timings(chain_cfg, scfg, seconds[:4], oracle, gpu,
                        engines=("pallas", "subband", "fourier"))
    report["timings"] = res
    for k, v in res["dedisp_s_per_gulp"].items():
        log(f"[timing] dedisp {k}: {v:.4f} s per {scfg.gulp_samps}-sample "
            "gulp")
    for k, v in res["search_stage_s"].items():
        log(f"[timing] search stage {k}: {v:.4f} s")
    for k, v in res["chain"].items():
        log(f"[timing] chain {k}: {v['ms_per_data_second']:.2f} ms per "
            f"data-second, agreement vs oracle "
            f"{v['agreement_vs_oracle']:.7f}")

    res = phase_end_to_end(cfg, scfg, seconds, nsec=40)
    report["end_to_end"] = res
    log(f"[e2e] {json.dumps(res)}")
    if not res["ok"]:
        _fail(report, "end-to-end FRB recovery")
    report["total_s"] = time.perf_counter() - t_all
    log(f"[done] {report['total_s']:.1f} s; card: {report['card']}")
    _save(report)
    log(result_line(dev))


if __name__ == "__main__":
    main()
