"""The full-array sharded step: every antenna's DSP, the cross-antenna
coadd, and the PRODUCTION candidate plane — one jitted SPMD program over an
(ant, time) mesh.

This replaces the reference's distributed topology (12 hosts of independent
process chains + per-beam heimdall searches + agdadacoadd MPI reduce +
agtriggerhook on the sum + a central coincidencer, SURVEY.md section 1,
scripts/start_heimdall_single_antenna:21, scripts/start_process:21) with
SPMD collectives, laid out the way the hardware wants it:

  * DSP phase — antennas shard over ALL devices (the mesh flattened):
    each antenna's seconds stream SEQUENTIALLY through the chain on one
    device, so the EMA bandpass carry is sequential-equivalent BY
    CONSTRUCTION (ref pb_kernels.cu:406-411) — packed output bytes are
    identical to the streaming StationPipeline's, with no cross-shard
    state mending.  The carried (bp, bp_kur) state enters and leaves the
    step, so consecutive calls continue one unbroken observation.
  * Reshard — one all_to_all over 'time' moves each antenna group's
    packed filterbank (cheap 2-bit bytes, not floats) from "whole stream
    on one device" to "time chunk per device": device (a, t) then holds
    chunk t of every beam in ant-row a's group.
  * Per-beam search — each device dedisperses + boxcar-filters its
    beams' chunk (the per-antenna heimdall role), with the previous
    chunk's tail pulled by ppermute (overlap-save; chunk 0 uses the
    packed tail carried from the previous call, so gulp overlap is
    seamless across calls).  Fixed-size packed top-k crossings per beam
    leave the device (the models/search._device_gulp pattern).
  * Coadd search — psum over 'ant' forms the incoherent sum (the
    agdadacoadd MPI reduce as a device all-reduce); the coadd chunk's
    search is time-SUBSPLIT across the 'ant' rows so the extra work
    rides otherwise-idle devices (the agtriggerhook role).

Host side, extract_candidates() turns the packed crossings into per-beam
and coadd Candidate lists via the same clustering the single-chip path
uses — feeding the identical coincidence/trigger plane (runtime/trigger).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from vlite_fast.config import ArrayConfig, SearchConfig
from vlite_fast.models import baseband_dsp as dsp
from vlite_fast.models import search as search_mod
from vlite_fast.ops import dedisperse as dd
from vlite_fast.ops import quantize as q_ops


class ArrayStepOutput(NamedTuple):
    packed_kur: jax.Array   # (nant, T, nbytes) per-beam filterbank bytes
    beam_topk: jax.Array    # (ndev, beams_per_group, 2, nbands*kb+1) int32
                            # [d]: ant-row d//ntblk's beams, chunk d%ntblk;
                            # banded packed crossings (pack_topk_banded)
    coadd_topk: jax.Array   # (ndev, 2, nbands*kb_co+1) int32 coadd crossings
    weights_mean: jax.Array  # (nant,) mean RFI weight over the call


@dataclasses.dataclass(frozen=True)
class ArraySearchInfo:
    """Static geometry the host needs to decode ArrayStepOutput."""

    widths: tuple
    dms: tuple
    T: int            # output samples per call
    c: int            # samples per time chunk (T // ntblk)
    ca: int           # coadd sub-window per ant row (c // na, or c)
    coadd_split: bool  # True when the coadd search is subsplit over 'ant'
    halo: int         # overlap-save lookahead (plan.max_delay)
    na: int
    ntblk: int
    m: int            # antennas per device
    mg: int           # beams per ant-row group (m * ntblk)
    nant: int
    k_beam: int
    k_co: int
    tsamp: float
    nbands: int = 1   # per-DM-band top-k quota (search.pack_topk_banded)


def build_array_step(acfg: ArrayConfig, mesh: Mesh,
                     nsec_per_call: int = 1,
                     k_beam: int = 0, k_co: int = 0,
                     inject_sec: int = -1):
    """Returns (step_fn, make_inputs, plan, info).

    inject_sec >= 0 arms the chain's FRB injection (requires
    pipeline.inject_frb=True) at the top of that second of the call, on
    every antenna — the in-graph signal test of the reference
    (src/process_baseband.cu:1098-1102 arms every 60 s); the search must
    then recover the burst at pipeline.inject_dm in every beam and in
    the coadd.

    step_fn(raw, bp, bp_kur, tail) -> (ArrayStepOutput, (bp2, bpk2, tail2))
      raw:  (nant, npol, nsec_per_call*sample_rate) uint8, P(('ant','time'))
      bp(_kur): (nant, npol, nchan) float32 EMA carry, same sharding
      tail: (nant, halo, nbytes) uint8 packed fb tail from the previous
            call (search overlap carry), same sharding

    Geometry requirements (raised if violated):
      nant % ndev == 0; T % ntblk == 0; halo <= c (a chunk's lookahead
      comes from ONE neighbor — make calls at least ntblk * halo samples
      long, the same reason heimdall's 24 s gulps exceed the DM-1000
      sweep).
    """
    cfg = acfg.pipeline
    scfg = acfg.search
    nant = acfg.nant
    na, ntblk = mesh.shape["ant"], mesh.shape["time"]
    ndev = na * ntblk
    if nant % ndev:
        raise ValueError(f"nant={nant} must divide over {ndev} devices")
    m = nant // ndev
    mg = m * ntblk                  # beams per ant-row group
    out_per_sec = cfg.seg_per_sec * cfg.out_samps_per_seg
    T = nsec_per_call * out_per_sec
    if T % ntblk:
        raise ValueError(f"T={T} output samples must divide into "
                         f"{ntblk} time chunks")
    c = T // ntblk

    freqs = cfg.freqs_mhz()
    dms = search_mod.make_dm_grid(scfg, cfg.tsamp, freqs)
    plan = dd.make_plan(dms, freqs, cfg.tsamp,
                        nsub=min(scfg.nsub, cfg.nchanout),
                        nbatch=min(scfg.nbatch, len(dms)),
                        zap_ranges=scfg.zap_ranges)
    halo = int(plan.max_delay)
    if halo > c:
        raise ValueError(
            f"chunk ({c} samples) shorter than the max DM delay ({halo}); "
            f"raise nsec_per_call to >= {ntblk * halo / out_per_sec:.1f} s "
            "or lower dm_max")
    widths = search_mod.boxcar_widths(scfg.boxcar_max)
    coadd_split = (c % na == 0)
    ca = c // na if coadd_split else c

    nbytes = cfg.npol_out * cfg.nchanout * cfg.nbit // 8
    nchan = cfg.nchanout
    use_kur = cfg.rfi_mode != 0
    engine = search_mod.resolve_engine(scfg.engine)
    cube_beam = len(widths) * len(dms) * c
    cube_co = len(widths) * len(dms) * ca
    k_beam = min(k_beam or max(512, 16 * scfg.max_candidates // ntblk),
                 cube_beam)
    k_co = min(k_co or max(512, 16 * scfg.max_candidates // (na * ntblk)),
               cube_co)
    inv_sqrt_nant = np.float32(1.0 / np.sqrt(nant))
    nbands = search_mod.effective_nbands(len(dms), scfg.topk_dm_bands)

    info = ArraySearchInfo(
        widths=widths, dms=tuple(float(d) for d in dms), T=T, c=c, ca=ca,
        coadd_split=coadd_split, halo=halo, na=na, ntblk=ntblk, m=m, mg=mg,
        nant=nant, k_beam=k_beam, k_co=k_co, tsamp=cfg.tsamp,
        nbands=nbands)

    def _search_topk(span, ntime_out, k):
        """span: (ntime_out + halo, nchan) f32 -> (2, nbands*kb + 1)
        packed crossings, per-DM-band quota'd (search.pack_topk_banded —
        the same RFI-storm guard the single-chip path uses)."""
        dmt = search_mod.dedisperse(engine, span, plan, ntime_out)
        snr = dd.boxcar_snr(dmt, plan.nchan_eff, widths)
        return search_mod.pack_topk_banded(snr, k, nbands,
                                           float(scfg.snr_thresh))

    def _dequant(packed):
        fb = q_ops.dequantize(packed, cfg.nbit)
        return fb.reshape(packed.shape[:-1] + (-1,))[..., :nchan]

    def shard_fn(raw, bp, bp_kur, tail):
        # ---- DSP: each local antenna streams its seconds sequentially ---
        # raw: (m, npol, nsec*rate); bp: (m, npol, nchan);
        # tail: (m, halo, nbytes)
        def one_ant(raw_a, bp_a, bpk_a):
            st = dsp.init_state(cfg)._replace(bp=bp_a, bp_kur=bpk_a)
            secs = raw_a.reshape(cfg.npol_in, nsec_per_call, -1)
            secs = jnp.swapaxes(secs, 0, 1)
            sec_idx = jnp.arange(nsec_per_call, dtype=jnp.int32)

            def step(s, sec_i):
                sec, i = sec_i
                arm = (jnp.equal(i, inject_sec) if inject_sec >= 0
                       else jnp.bool_(False))
                o, s2 = dsp.process_second(cfg, sec, s, arm)
                pk = o.packed_kur if use_kur else o.packed
                return s2, (pk, o.weights.mean())

            st2, (pk, wm) = jax.lax.scan(step, st, (secs, sec_idx))
            return (pk.reshape(T, nbytes), wm.mean(),
                    st2.bp, st2.bp_kur)

        packed, wmean, bp2, bpk2 = jax.vmap(one_ant)(raw, bp, bp_kur)

        # next call's search tail: the last `halo` packed rows of the
        # stream (prepend the incoming tail so halo > T also works)
        tail2 = jnp.concatenate([tail, packed], axis=1)[:, -halo:]

        # ---- reshard: (m, T, nb) -> group beams x my chunk -------------
        x = packed.reshape(m, ntblk, c, nbytes)
        # all_to_all consumes the chunk axis (one piece per time peer) and
        # materializes the 'time' axis at position 0, ordered by source:
        # (ntblk, m, c, nb).  Beam order within the group is therefore
        # (source t', local antenna i) — matching the all_gathered tails.
        x = jax.lax.all_to_all(x, "time", split_axis=1, concat_axis=0,
                               tiled=False)
        chunk = x.reshape(mg, c, nbytes)

        # ---- previous-chunk halo (overlap-save) -------------------------
        t_idx = jax.lax.axis_index("time")
        prev_in_call = jax.lax.ppermute(
            chunk[:, -halo:], "time",
            [(i, (i + 1) % ntblk) for i in range(ntblk)])
        # chunk 0's history is the PREVIOUS call's tail (the input), not
        # the tail just computed from this call's end
        group_tails = jax.lax.all_gather(tail, "time")  # (ntblk, m, halo, nb)
        group_tails = group_tails.reshape(mg, halo, nbytes)
        prev = jnp.where(t_idx == 0, group_tails, prev_in_call)
        span_packed = jnp.concatenate([prev, chunk], axis=1)
        fb_span = _dequant(span_packed)          # (mg, c+halo, nchan) f32

        # ---- per-beam search (the heimdall-per-antenna role) ------------
        # beams one after another: a beam's DM-time plane and S/N cube
        # are the search's largest intermediates
        beam_topk = jax.lax.map(lambda s: _search_topk(s, c, k_beam),
                                fb_span)

        # ---- coadd + subsplit search (agdadacoadd + agtriggerhook) ------
        co = jax.lax.psum(fb_span.sum(axis=0), "ant") * inv_sqrt_nant
        a_idx = jax.lax.axis_index("ant")
        start = a_idx * ca if coadd_split else 0
        sub = jax.lax.dynamic_slice_in_dim(co, start, ca + halo, axis=0)
        coadd_topk = _search_topk(sub, ca, k_co)

        return (packed, beam_topk[None], coadd_topk[None], wmean,
                bp2, bpk2, tail2)

    spec_at = P(("ant", "time"))
    mapped = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(spec_at, spec_at, spec_at, spec_at),
        out_specs=(spec_at, spec_at, spec_at, spec_at,
                   spec_at, spec_at, spec_at),
        check_vma=False)

    @jax.jit
    def step_fn(raw, bp, bp_kur, tail):
        packed, btk, ctk, wmean, bp2, bpk2, tail2 = mapped(
            raw, bp, bp_kur, tail)
        return (ArrayStepOutput(packed, btk, ctk, wmean),
                (bp2, bpk2, tail2))

    def make_inputs(seed: int = 0):
        rng = np.random.default_rng(seed)
        nsamp = nsec_per_call * cfg.sample_rate
        raw = np.clip(rng.standard_normal(
            (nant, cfg.npol_in, nsamp)) / 0.05914 + 128.5,
            0, 255).astype(np.uint8)
        bp = np.zeros((nant, cfg.npol_in, cfg.nchan), np.float32)
        # the first call's warm-up history (there is no data before the
        # observation): RANDOM quantizer levels, not a constant — a
        # constant fill makes the per-trial robust noise estimate of
        # fill-dominated rows collapse to ~0, exploding S/N at the stream
        # head; random levels over-estimate sigma there instead
        # (conservative: the first halo is slightly de-weighted, the way
        # heimdall's first gulp simply starts at sample 0)
        tail = rng.integers(0, 256, (nant, halo, nbytes),
                            dtype=np.uint8)
        sh = NamedSharding(mesh, spec_at)

        def put(a):
            # make_array_from_callback instead of device_put: in a
            # multi-controller run each process materializes only its
            # addressable shards, so the same make_inputs serves the
            # single-process virtual mesh AND the 2-process DCN test
            return jax.make_array_from_callback(a.shape, sh,
                                                lambda idx: a[idx])

        return put(raw), put(bp), put(bp.copy()), put(tail)

    return step_fn, make_inputs, plan, info


def extract_candidates(out: ArrayStepOutput, info: ArraySearchInfo,
                       scfg: SearchConfig, call_base: int = 0
                       ) -> Tuple[Dict[int, List[dd.Candidate]],
                                  List[dd.Candidate], Dict[str, int]]:
    """Decode one step's packed crossings into the candidate plane.

    Returns ({beam: [Candidate]}, [coadd Candidate], stats) with peak/
    i0/i1 sample indices ABSOLUTE in the observation's output-sample
    stream (call_base = T * call_index).  The searched span of call k is
    [call_base - halo, call_base + T - halo): the trailing halo samples
    wait for the next call's lookahead, exactly like heimdall's gulp
    overlap.  Crossings below scfg.snr_thresh or before sample 0 are
    dropped; clustering is the single-chip cluster_hits.  stats carries
    the in-graph crossing counts and the number of saturated top-k DM
    bands across all shards (search.decode_crossings semantics).
    """
    dms = np.asarray(info.dms)
    nw, ndm = len(info.widths), len(dms)
    stats = {"n_crossings": 0, "saturated_bands": 0}

    btk = np.asarray(out.beam_topk)      # (ndev, mg, 2, nbands*kb+1)
    per_beam_hits: Dict[int, list] = {}
    for d in range(btk.shape[0]):
        a, t = d // info.ntblk, d % info.ntblk
        base = call_base - info.halo + t * info.c
        for j in range(info.mg):
            beam = a * info.mg + j
            vals, hits, n_cross, sat = search_mod.decode_crossings(
                btk[d, j], nw, ndm, info.c, info.nbands, scfg.snr_thresh)
            stats["n_crossings"] += n_cross
            stats["saturated_bands"] += sat
            if not len(vals):
                continue
            hits = hits.copy()
            hits[:, 2] += base
            ok = hits[:, 2] >= 0
            if ok.any():
                h, v = per_beam_hits.setdefault(beam, ([], []))
                h.append(hits[ok])
                v.append(vals[ok])

    per_beam: Dict[int, List[dd.Candidate]] = {}
    for beam, (h, v) in per_beam_hits.items():
        per_beam[beam] = dd.cluster_hits(
            np.concatenate(h), np.concatenate(v), dms, info.tsamp,
            widths=info.widths, max_cands=scfg.max_candidates)

    ctk = np.asarray(out.coadd_topk)     # (ndev, 2, nbands*kb_co+1)
    ch, cv = [], []
    for d in range(ctk.shape[0]):
        a, t = d // info.ntblk, d % info.ntblk
        if not info.coadd_split and a != 0:
            continue            # unsplit: every ant row searched the same
        base = call_base - info.halo + t * info.c + a * info.ca \
            if info.coadd_split else call_base - info.halo + t * info.c
        vals, hits, n_cross, sat = search_mod.decode_crossings(
            ctk[d], nw, ndm, info.ca, info.nbands, scfg.snr_thresh)
        stats["n_crossings"] += n_cross
        stats["saturated_bands"] += sat
        if not len(vals):
            continue
        hits = hits.copy()
        hits[:, 2] += base
        ok = hits[:, 2] >= 0
        if ok.any():
            ch.append(hits[ok])
            cv.append(vals[ok])
    coadd_cands: List[dd.Candidate] = []
    if ch:
        coadd_cands = dd.cluster_hits(
            np.concatenate(ch), np.concatenate(cv), dms, info.tsamp,
            widths=info.widths, max_cands=scfg.max_candidates)
    return per_beam, coadd_cands, stats
