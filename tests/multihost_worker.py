"""Worker script for the two-process multi-controller tests.

Each process is one 'host' of the cluster: jax.distributed wires them into
a single logical device mesh (CPU backend, 2 virtual devices per process),
each host contributes its local antennas' data, and the collectives run
across process boundaries — the DCN path of SURVEY.md section 5 exercised
for real, not just on a single-process virtual mesh.

Modes:
  coadd      — minimal psum over 'ant' across the process boundary
  arraystep  — the FULL production sharded step (build_array_step: DSP,
               all_to_all reshard, ppermute halos, per-beam + coadd top-k)
               over a (ant=2, time=2) mesh split across 2 processes, with
               the candidate plane decoded host-side.  The test compares
               the printed summary against a single-process run of the
               identical geometry/seed.

Usage: python multihost_worker.py <process_id> <num_processes> <port> [mode]
Prints one JSON line for cross-process comparison.
"""

import hashlib
import json
import sys


def arraystep_config():
    """The shared tiny geometry for the cross-process array-step test
    (also used by the in-process reference run in test_multihost)."""
    import dataclasses

    from vlite_fast.config import ArrayConfig, PipelineConfig

    acfg = ArrayConfig.tiny(nant=4, mesh_ant=2, mesh_time=2)
    # ema_impl='assoc': the cross-process bit-exactness contract needs
    # the batch/partition-invariant EMA (the default 'matmul' lowers its
    # dot differently across device layouts — bounded in
    # tests/test_chain.py::test_ema_matmul_near_exact)
    return dataclasses.replace(
        acfg, pipeline=PipelineConfig.tiny(sample_rate=100_000,
                                           ema_impl="assoc"))


def arraystep_summary(acfg, mesh, seed=7):
    """Build + run one sharded step on `mesh` and return the JSON-able
    candidate-plane summary.  Works on a single-process virtual mesh and
    on a multi-controller mesh alike: outputs are resharded to replicated
    inside jit, so every process holds the full (small) result."""
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from vlite_fast.parallel.sharded_pipeline import (
        ArrayStepOutput, build_array_step, extract_candidates)

    step_fn, make_inputs, plan, info = build_array_step(
        acfg, mesh, nsec_per_call=2)
    raw, bp, bp_kur, tail = make_inputs(seed=seed)
    out, state = step_fn(raw, bp, bp_kur, tail)

    rep = jax.jit(lambda t: t,
                  out_shardings=NamedSharding(mesh, P()))
    full = rep(tuple(out))
    pk, btk, ctk, wm = [np.asarray(a.addressable_data(0)) for a in full]
    per_beam, coadd, stats = extract_candidates(
        ArrayStepOutput(pk, btk, ctk, wm), info, acfg.search)

    def cands(cl):
        return [[round(float(c.snr), 3), round(float(c.dm), 3),
                 int(c.peak_idx), int(c.tfilt)] for c in cl]

    return {
        "packed_sha": hashlib.sha256(pk.tobytes()).hexdigest(),
        "weights_mean": [round(float(w), 5) for w in wm],
        "per_beam": {str(b): cands(cl) for b, cl in sorted(per_beam.items())},
        "coadd": cands(coadd),
        "stats": stats,
    }


def obs_config():
    """Shared geometry for the 2-process full-observation soak: the
    dryrun_multichip detection config (tiny chain + in-graph FRB at
    DM 300) over a (ant=2, time=2) mesh, 4 antennas, two 4 s calls."""
    import dataclasses

    from vlite_fast.config import (AntennaConfig, ArrayConfig,
                                       PipelineConfig, SearchConfig)

    dm_true = 300.0
    cfg = dataclasses.replace(
        PipelineConfig.tiny(freq_top_mhz=320.5, bandwidth_mhz=0.5,
                            ema_impl="assoc"),
        inject_frb=True, inject_dm=dm_true, inject_amp=1.3)
    scfg = SearchConfig(dm_min=0.0, dm_max=600.0, ndm=64,
                        gulp_samps=512, boxcar_max=16, zap_ranges=(),
                        snr_thresh=6.0, engine="subband",
                        dm_grid_mode="linear")
    return ArrayConfig(
        antennas=tuple(AntennaConfig(i + 1, f"ea{i + 1:02d}")
                       for i in range(4)),
        pipeline=cfg, search=scfg, mesh_ant=2, mesh_time=2), dm_true


def run_observation(pid, nproc, base_port):
    """VERDICT r4 item 8: a sustained multi-second observation across 2
    real processes, end to end — VDIF capture-replay (SecondAssembler at
    wire framing), the sharded DSP+search step (armed call then plain
    call, EMA/tail state carried), host candidate extraction, and
    cross-process TCP candidate shipping into the central coincidencer,
    which must trigger on the injected burst only once >=3 beams (i.e.
    BOTH processes) have reported.  Ref topology:
    scripts/start_coadd:22-57 + src/trigger.py:87-176."""
    import time

    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from vlite_fast import constants as C
    from vlite_fast.config import TriggerConfig
    from vlite_fast.parallel.mesh import make_mesh
    from vlite_fast.parallel.sharded_pipeline import (
        ArrayStepOutput, build_array_step, extract_candidates)
    from vlite_fast.runtime.candidate_server import (
        CandidateClient, CoincidencerServer)
    from vlite_fast.runtime.capture import SecondAssembler
    from vlite_fast.utils import vdif

    acfg, dm_true = obs_config()
    cfg = acfg.pipeline
    nant, nsec, ncalls = 4, 4, 2
    mesh = make_mesh(n_ant=2, n_time=2)

    # ---- capture plane: VDIF-framed noise through SecondAssembler ----
    rate = cfg.sample_rate
    nsec_total = nsec * ncalls
    raw_all = np.empty((nant, cfg.npol_in, nsec_total * rate), np.uint8)
    cap_stats = []
    for a in range(nant):
        rng = np.random.default_rng(100 + a)
        samples = np.clip(rng.standard_normal(
            (cfg.npol_in, nsec_total * rate)) / 0.05914 + 128.5,
            0, 255).astype(np.uint8)
        stream = vdif.streams_to_frames(samples, ref_epoch=40,
                                        start_second=100,
                                        sample_rate=rate)
        asm = SecondAssembler(sample_rate=rate)
        secs = []
        chunk = 4096 * C.VDIF_FRAME_BYTES
        for off in range(0, len(stream), chunk):
            secs.extend(asm.feed_stream(stream[off:off + chunk]))
        secs.extend(asm.flush())
        assert len(secs) == nsec_total, (a, len(secs))
        for k, (s, buf) in enumerate(secs):
            assert s == 100 + k
            raw_all[a, :, k * rate:(k + 1) * rate] = buf
        assert np.array_equal(
            raw_all[a].reshape(cfg.npol_in, -1), samples), a
        cap_stats.append({"frames": asm.stats.frames,
                          "skipped": asm.stats.skipped,
                          "anomalous": asm.stats.anomalous})

    # ---- the sharded step programs: armed twin + plain twin ----------
    step_armed, make_inputs, plan, info = build_array_step(
        acfg, mesh, nsec_per_call=nsec, inject_sec=1)
    step_plain, _, _, _ = build_array_step(
        acfg, mesh, nsec_per_call=nsec, inject_sec=-1)
    _, bp, bp_kur, tail = make_inputs(seed=0)
    sh = NamedSharding(mesh, P(("ant", "time")))

    def put(a):
        return jax.make_array_from_callback(a.shape, sh,
                                            lambda idx: a[idx])

    rep = jax.jit(lambda t: t, out_shardings=NamedSharding(mesh, P()))
    summaries = []
    state = (bp, bp_kur, tail)
    per_call_cands = []
    for k in range(ncalls):
        raw_k = put(np.ascontiguousarray(
            raw_all[:, :, k * nsec * rate:(k + 1) * nsec * rate]))
        step = step_armed if k == 0 else step_plain
        out, state = step(raw_k, *state)
        full = rep(tuple(out))
        pk, btk, ctk, wm = [np.asarray(x.addressable_data(0))
                            for x in full]
        per_beam, coadd, stats = extract_candidates(
            ArrayStepOutput(pk, btk, ctk, wm), info, acfg.search,
            call_base=k * info.T)
        per_call_cands.append((per_beam, coadd))
        summaries.append({
            "packed_sha": hashlib.sha256(pk.tobytes()).hexdigest(),
            "beams_with_cands": len(per_beam),
            "coadd_cands": len(coadd),
            "n_crossings": stats["n_crossings"],
        })

    # the armed call must recover the burst in every beam + the coadd
    per_beam0, coadd0 = per_call_cands[0]
    dm_step = info.dms[1] - info.dms[0]
    for beam in range(nant):
        cands = per_beam0.get(beam, [])
        assert cands, f"beam {beam}: burst not recovered"
        best = max(cands, key=lambda c: c.snr)
        assert abs(best.dm - dm_true) <= 4 * dm_step, (beam, best)
    assert coadd0, "burst not recovered in coadd"

    # ---- candidate shipping: each process ships ITS beams over TCP ---
    utc = "2026-01-02-03:04:05"
    tcfg = TriggerConfig(snr_thresh=6.0, min_beams=3)
    srv = None
    if pid == 0:
        srv = CoincidencerServer(port=base_port + 1, tsamp=info.tsamp,
                                 tcfg=tcfg)
    client = CandidateClient(port=base_port + 1)
    my_beams = range(pid * 2, pid * 2 + 2)
    deadline = time.time() + 30
    for beam in my_beams:
        cands = per_beam0.get(beam, [])
        while True:
            try:
                client.send(utc, beam, cands)
                break
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(0.2)

    result = {"cap": cap_stats[0], "calls": summaries}
    if pid == 0:
        while not srv.triggers and time.time() < deadline:
            time.sleep(0.2)
        assert srv.triggers, "coincidencer produced no trigger"
        t = srv.triggers[0]
        assert abs(t.dm - dm_true) <= 4 * dm_step, t
        result["triggers"] = [{"dm": round(float(t.dm), 1),
                               "sn": round(float(t.sn), 1),
                               "meta": t.meta}
                              for t in srv.triggers]
        srv.close()
    summary = dict(result, pid=pid, devices=len(jax.devices()),
                   local_devices=len(jax.local_devices()))
    print(json.dumps(summary), flush=True)
    return len(jax.devices()) == 4


def run_coadd(pid, nproc):
    import numpy as np
    from jax.sharding import PartitionSpec as P
    from jax import shard_map
    import jax

    from vlite_fast.parallel.mesh import make_mesh
    from vlite_fast.parallel.distributed import (local_antenna_slice,
                                                     make_global_array)
    from vlite_fast.models.coadd import coadd_psum

    nant = 4  # one antenna per global device
    mesh = make_mesh(n_ant=4, n_time=1)
    sl = local_antenna_slice(nant)
    # each host synthesizes ITS antennas' filterbank blocks (deterministic
    # per antenna so the result is checkable)
    local = np.stack([
        np.full((8, 16), float(a + 1), np.float32)
        for a in range(nant)[sl]])
    garr = make_global_array(local, mesh, P("ant", None, None))

    def f(fb_local):
        return coadd_psum(fb_local, "ant", nant)[None]

    mapped = shard_map(f, mesh=mesh, in_specs=P("ant", None, None),
                       out_specs=P("ant", None, None), check_vma=False)
    out = mapped(garr)
    # every shard holds the same coadd: sum(1..4)/sqrt(4) = 5.0
    local_vals = [np.asarray(s.data) for s in out.addressable_shards]
    checks = [float(v.mean()) for v in local_vals]
    print(json.dumps({"pid": pid, "devices": len(jax.devices()),
                      "local_devices": len(jax.local_devices()),
                      "coadd_means": checks}), flush=True)
    return all(abs(c - 5.0) < 1e-5 for c in checks) \
        and len(jax.devices()) == 4


def run_arraystep(pid, nproc):
    import jax

    from vlite_fast.parallel.mesh import make_mesh

    mesh = make_mesh(n_ant=2, n_time=2)
    summary = arraystep_summary(arraystep_config(), mesh)
    summary.update(pid=pid, devices=len(jax.devices()),
                   local_devices=len(jax.local_devices()))
    print(json.dumps(summary), flush=True)
    return len(jax.devices()) == 4


def main():
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    mode = sys.argv[4] if len(sys.argv) > 4 else "coadd"
    import os
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                               num_processes=nproc, process_id=pid)
    if mode == "coadd":
        ok = run_coadd(pid, nproc)
    elif mode == "observation":
        ok = run_observation(pid, nproc, port)
    else:
        ok = run_arraystep(pid, nproc)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
