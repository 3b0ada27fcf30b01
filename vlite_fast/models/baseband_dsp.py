"""The per-antenna streaming DSP chain — the system's flagship model.

A JAX re-design of process_baseband (ref src/process_baseband.cu:334,
segment dispatch :1108-1458): one pure, jittable function maps a
1/seg_per_sec-second chunk of raw 8-bit voltages to quantized filterbank bytes, threading the
carried state (EMA bandpass per stream) explicitly.  A second of data is a
lax.scan of that function over its seg_per_sec segments; an observation is the host
runtime repeatedly feeding seconds (runtime/pipeline.py).

Chain per segment (matching the reference launch order at
process_baseband.cu:1152-1360):

  uint8 (npol, seg_samps)
    -> convert            (pb_kernels convertarray)
    -> [rfi_mode>0] kurtosis stats + D'Agostino + mask  (ops.kurtosis)
    -> rfft channelize    (cufftExecR2C)
    -> [inject] FRB track multiply                      (ops.injection)
    -> detect + EMA bandpass normalize [weighted]       (ops.normalize)
    -> pscrunch [+weights] -> tscrunch [+weights]
    -> channel trim + quantize + pack                   (ops.quantize)
  -> packed uint8 (out_samps, bytes_per_samp) x {plain, kur} streams

rfi_mode semantics match the reference (-r flag, process_baseband.cu:449):
0 = no excision (plain stream only), 1 = excision in place (kur stream
only), 2 = both streams (default).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from vlite_fast.config import PipelineConfig
from vlite_fast.ops import channelize as ch_ops
from vlite_fast.ops import injection as inj_ops
from vlite_fast.ops import kurtosis as kur_ops
from vlite_fast.ops import normalize as norm_ops
from vlite_fast.ops import quantize as q_ops
from vlite_fast.ops import unpack as unpack_ops


class DSPState(NamedTuple):
    """Carried DSP state (the only cross-segment state in the chain,
    SURVEY.md section 5 'checkpoint/resume')."""

    bp: jax.Array        # (npol, nchan) plain-stream bandpass
    bp_kur: jax.Array    # (npol, nchan) kurtosis-stream bandpass
    segs_since_inject: jax.Array  # int32 scalar; <0 means not armed
    tail: jax.Array      # (2, npol, (pfb_ntap-1)*nfft) carried voltages
                         # for the streaming WOLA channelizer — stream 0
                         # plain, stream 1 RFI-masked ((2, npol, 0) unless
                         # channelizer == 'pfb')
    wtail: jax.Array     # (npol, pfb_ntap-1) carried per-block kurtosis
                         # weights for the WOLA weight bookkeeping
                         # ((npol, 0) unless channelizer == 'pfb')


class SegmentOutput(NamedTuple):
    packed: jax.Array       # (out_samps, nbytes) plain stream ('' if mode 1)
    packed_kur: jax.Array   # (out_samps, nbytes) kur stream ('' if mode 0)
    weights: jax.Array      # (npol, ffts_per_seg) kurtosis weights
    dag_frac: jax.Array     # scalar: fraction of fine windows flagged
    histo: jax.Array = None  # (npol, 256) raw-sample histogram (DOHISTO,
                             # ref pb_kernels.cu:321-336) when cfg.do_histo


def init_state(cfg: PipelineConfig) -> DSPState:
    pfb = cfg.channelizer == "pfb"
    tail_len = (cfg.pfb_ntap - 1) * cfg.nfft if pfb else 0
    wtail_len = (cfg.pfb_ntap - 1) if pfb else 0
    return DSPState(
        bp=jnp.zeros((cfg.npol_in, cfg.nchan), jnp.float32),
        bp_kur=jnp.zeros((cfg.npol_in, cfg.nchan), jnp.float32),
        segs_since_inject=jnp.int32(-1),
        tail=jnp.zeros((2, cfg.npol_in, tail_len), jnp.float32),
        wtail=jnp.ones((cfg.npol_in, wtail_len), jnp.float32),
    )


def _frb_delays_np(cfg: PipelineConfig) -> np.ndarray:
    spectra_per_sec = cfg.seg_per_sec * cfg.ffts_per_seg
    return inj_ops.frb_delays(
        cfg.nchan, cfg.inject_dm, spectra_per_sec,
        freq_top_ghz=cfg.freq_top_mhz / 1e3,
        bandwidth_ghz=cfg.bandwidth_mhz / 1e3)


def _frb_delay_array(cfg: PipelineConfig) -> jax.Array:
    return jnp.asarray(_frb_delays_np(cfg))


def _inject_active_limit_segs(cfg: PipelineConfig) -> int:
    """Last segment index (since arming) whose spectra can still lie on
    the injected track: the DM-80 sweep bottoms out max(delays) + width
    spectra after the top-of-band arrival (~1.2 s of the 60 s arming
    period, ref src/process_baseband.cu:1098-1102)."""
    width = cfg.inject_width_s * cfg.seg_per_sec * cfg.ffts_per_seg
    max_d = float(_frb_delays_np(cfg).max())
    return int(np.ceil((max_d + width) / cfg.ffts_per_seg)) + 1


def inject_window_seconds(cfg: PipelineConfig) -> int:
    """Whole seconds (from the arming second, inclusive) during which the
    injected track can still intersect the data.  Host runtimes use this
    to dispatch the injection-free compiled chain outside the window:
    the track multiply + select cost two extra passes over the spectra
    plane per segment, and an in-graph lax.cond would put an operand
    boundary between the DFT and detect.  Outside the window the
    injection path multiplies by all-ones, so skipping it is
    byte-exact."""
    return int(np.ceil((_inject_active_limit_segs(cfg) + 1)
                       / cfg.seg_per_sec)) + 1


def _rfi_stage(cfg: PipelineConfig, x: jax.Array):
    """RFI excision front (ops/kurtosis): (masked voltages, weights,
    dag_frac)."""
    weights = jnp.ones((cfg.npol_in, cfg.ffts_per_seg), jnp.float32)
    dag_frac = jnp.float32(0.0)
    if cfg.rfi_mode == 0:
        return x, weights, dag_frac
    res = kur_ops.rfi_excise(x, cfg.nkurto, cfg.nfft,
                             dag_thresh=cfg.dag_thresh,
                             dag_fb_thresh=cfg.dag_fb_thresh)
    dag_frac = jnp.mean((res.dag >= cfg.dag_thresh).astype(jnp.float32))
    return res.masked, res.weights, dag_frac


def use_framed_front(cfg: PipelineConfig) -> bool:
    """True when the segment front-end can run entirely in the DFT's
    (b, n1, n2) frame layout (ops/kurtosis.rfi_excise_framed): the uint8
    bytes are reshaped ONCE and no float voltage array changes layout
    (the flat path reshapes the f32 voltages twice per segment: window
    reshape + CT reshape)."""
    if (cfg.front_layout not in ("frames", "mixed")
            or cfg.channelizer != "matmul"):
        return False
    if cfg.batch_streams:
        return False
    n1, n2 = ch_ops._ct_split(cfg.nfft)
    # a fine window must be a whole number of n1-rows (then windows per
    # block * rows per window == n1 automatically, since nfft = n1*n2)
    return cfg.nkurto % n2 == 0 and cfg.nfft % cfg.nkurto == 0


def process_segment(cfg: PipelineConfig, raw: jax.Array,
                    state: DSPState) -> tuple[SegmentOutput, DSPState]:
    """One 1/seg_per_sec-second chunk through the full chain.

    raw: (npol_in, seg_samps) uint8. Pure function of (raw, state).
    """
    framed = use_framed_front(cfg)
    if framed:
        n1, n2 = ch_ops._ct_split(cfg.nfft)
        xb = raw.reshape(cfg.npol_in * cfg.ffts_per_seg, n1, n2)
        weights = jnp.ones((cfg.npol_in, cfg.ffts_per_seg), jnp.float32)
        dag_frac = jnp.float32(0.0)
        if cfg.rfi_mode > 0:
            if cfg.front_layout == "frames":
                fr = kur_ops.rfi_excise_framed(
                    xb, cfg.npol_in, cfg.nkurto, cfg.nfft,
                    dag_thresh=cfg.dag_thresh,
                    dag_fb_thresh=cfg.dag_fb_thresh)
                weights, dag, row_keep = fr.weights, fr.dag, fr.row_keep
                x = fr.xf
            else:
                # 'mixed': kurtosis stats on the flat lane-aligned
                # layout, only convert+mask in frame layout (the select
                # fuses into the DFT operand; the flat masked voltages
                # are never materialized)
                res = kur_ops.rfi_excise(
                    unpack_ops.convert_uint8(raw), cfg.nkurto, cfg.nfft,
                    dag_thresh=cfg.dag_thresh,
                    dag_fb_thresh=cfg.dag_fb_thresh)
                weights, dag = res.weights, res.dag
                row_keep = kur_ops.row_keep_from_dag(
                    dag, res.dag_fb, cfg.npol_in, cfg.nkurto, cfg.nfft,
                    n2, dag_thresh=cfg.dag_thresh,
                    dag_fb_thresh=cfg.dag_fb_thresh)
                x = unpack_ops.convert_uint8(xb)
            dag_frac = jnp.mean((dag >= cfg.dag_thresh)
                                .astype(jnp.float32))
            # the mask select fuses into the DFT's stage-1 operand read
            x_kur = jnp.where(row_keep[:, :, None], x, 0.0)
        else:
            x = unpack_ops.convert_uint8(xb)
            x_kur = x
    else:
        x = unpack_ops.convert_uint8(raw)
        x_kur, weights, dag_frac = _rfi_stage(cfg, x)

    new_tail, new_wtail = state.tail, state.wtail
    if framed:
        def spectra(v, stream=0):
            out = ch_ops.matmul_rfft_framed(
                v, cfg.nfft, precision=cfg.dft_precision,
                exact_bf16_input=cfg.dft_exact_input,
                stage2=cfg.dft_stage2)
            return out.reshape(cfg.npol_in, cfg.ffts_per_seg, -1)
    elif cfg.channelizer == "pfb":
        # streaming WOLA: prepend the carried (ntap-1)*nfft voltages so
        # this segment yields exactly ffts_per_seg spectra, then carry the
        # segment's own tail forward (genbase's overlap pattern applied to
        # the analysis side).  Stream 0 carries plain voltages, stream 1
        # the RFI-masked ones; the kurtosis weights get the matching
        # WOLA-window bookkeeping (ch_ops.pfb_weights).
        def spectra(v, stream=0):
            v_ext = jnp.concatenate([state.tail[stream], v], axis=1)
            return ch_ops.polyphase_channelize(v_ext, cfg.nfft,
                                               cfg.pfb_ntap,
                                               method="matmul",
                                               precision=cfg.dft_precision)

        tl = (cfg.pfb_ntap - 1) * cfg.nfft
        new_tail = jnp.stack([x[:, -tl:], x_kur[:, -tl:]])
        if cfg.rfi_mode > 0:
            w_ext = jnp.concatenate([state.wtail, weights], axis=1)
            new_wtail = weights[:, -(cfg.pfb_ntap - 1):]
            weights = ch_ops.pfb_weights(w_ext, cfg.pfb_ntap, cfg.nfft)
    else:
        def spectra(v, stream=0):
            # voltages are exact k/128 values (masking only zeroes):
            # stage 1 of the 'high' DFT runs in 2 bf16 passes
            return ch_ops.channelize(v, cfg.nfft, method=cfg.channelizer,
                                     precision=cfg.dft_precision,
                                     exact_bf16_input=cfg.dft_exact_input,
                                     stage2=cfg.dft_stage2)

    def maybe_inject(spec):
        if not cfg.inject_frb:
            return spec
        delays = _frb_delay_array(cfg)
        width = cfg.inject_width_s * cfg.seg_per_sec * cfg.ffts_per_seg
        since = state.segs_since_inject * cfg.ffts_per_seg
        injected = inj_ops.inject_frb(spec, delays, since, width,
                                      cfg.inject_amp)
        return jnp.where(state.segs_since_inject >= 0, injected, spec)

    if cfg.ema_impl == "matmul":
        ema = norm_ops.normalize_ema_matmul
        ema_w = norm_ops.normalize_ema_weighted_matmul
    elif cfg.ema_impl == "assoc":
        ema = norm_ops.normalize_ema_assoc
        ema_w = norm_ops.normalize_ema_weighted_assoc
    else:
        ema = norm_ops.normalize_ema
        ema_w = norm_ops.normalize_ema_weighted

    def finish_plain(spec, bp):
        p = norm_ops.detect(spec)
        out, bp_new = ema(p, bp, cfg.bp_scale)
        if cfg.npol_out == 1 and cfg.npol_in == 2:
            out = norm_ops.pscrunch(out)
        out = norm_ops.tscrunch(out, cfg.nscrunch)
        packed = q_ops.sel_and_dig(out, cfg.chanmin, cfg.chanmax, cfg.nbit)
        return packed, bp_new

    def finish_kur(spec, bp):
        p = norm_ops.detect(spec)
        out, bp_new = ema_w(p, weights, bp, cfg.bp_scale)
        w = weights
        if cfg.npol_out == 1 and cfg.npol_in == 2:
            out, w = norm_ops.pscrunch_weights(out, w, cfg.min_weight)
        out = norm_ops.tscrunch_weights(out, w, cfg.nscrunch, cfg.min_weight)
        packed = q_ops.sel_and_dig(out, cfg.chanmin, cfg.chanmax, cfg.nbit)
        return packed, bp_new

    bp, bp_kur = state.bp, state.bp_kur
    nbytes = cfg.npol_out * cfg.nchanout * cfg.nbit // 8
    empty = jnp.zeros((cfg.out_samps_per_seg, nbytes), jnp.uint8)
    if cfg.rfi_mode == 0:
        packed, bp = finish_plain(maybe_inject(spectra(x)), bp)
        packed_kur = empty
    elif cfg.rfi_mode == 1:
        packed_kur, bp_kur = finish_kur(
            maybe_inject(spectra(x_kur, 1)), bp_kur)
        packed = empty
    elif cfg.batch_streams and cfg.channelizer != "pfb":
        # one 2x-batched DFT over [plain; masked] voltages (re-testable
        # alternative; see cfg.batch_streams for the measurement history)
        spec2 = ch_ops.channelize(jnp.concatenate([x, x_kur], axis=0),
                                  cfg.nfft, method=cfg.channelizer,
                                  precision=cfg.dft_precision,
                                  exact_bf16_input=cfg.dft_exact_input,
                                  stage2=cfg.dft_stage2)
        packed, bp = finish_plain(maybe_inject(spec2[:cfg.npol_in]), bp)
        packed_kur, bp_kur = finish_kur(
            maybe_inject(spec2[cfg.npol_in:]), bp_kur)
    else:
        # sequential per-stream DFTs (XLA pipelines producer/consumer
        # pairs across the streams)
        packed, bp = finish_plain(maybe_inject(spectra(x)), bp)
        packed_kur, bp_kur = finish_kur(
            maybe_inject(spectra(x_kur, 1)), bp_kur)

    new_since = jnp.where(state.segs_since_inject >= 0,
                          state.segs_since_inject + 1,
                          state.segs_since_inject)
    new_state = DSPState(bp=bp, bp_kur=bp_kur, segs_since_inject=new_since,
                         tail=new_tail, wtail=new_wtail)
    return SegmentOutput(packed, packed_kur, weights, dag_frac), new_state


@partial(jax.jit, static_argnames=("cfg",))
def process_second(cfg: PipelineConfig, raw_second: jax.Array,
                   state: DSPState, arm_inject: jax.Array
                   ) -> tuple[SegmentOutput, DSPState]:
    """One second through the full chain.

    raw_second: (npol_in, sample_rate) uint8.  arm_inject: bool scalar —
    start an FRB at the top of this second (ref process_baseband.cu:1098:
    armed when current_sec % 60 == 0).
    Outputs are concatenated over segments (time-major): a lax.scan of
    process_segment, the EMA carried from segment to segment.
    """
    segs = raw_second.reshape(cfg.npol_in, cfg.seg_per_sec,
                              cfg.seg_samps).swapaxes(0, 1)
    state = state._replace(segs_since_inject=jnp.where(
        arm_inject, jnp.int32(0), state.segs_since_inject))

    def step(st, seg):
        out, st2 = process_segment(cfg, seg, st)
        return st2, out

    state, outs = jax.lax.scan(step, state, segs)
    merge = lambda a: a.reshape((-1,) + a.shape[2:])
    histo = kur_ops.sample_histogram(raw_second) if cfg.do_histo \
        else jnp.zeros((cfg.npol_in, 0), jnp.int32)
    return SegmentOutput(
        packed=merge(outs.packed),
        packed_kur=merge(outs.packed_kur),
        weights=jnp.swapaxes(outs.weights, 0, 1).reshape(
            cfg.npol_in, -1),
        dag_frac=jnp.mean(outs.dag_frac),
        histo=histo,
    ), state


def reference_chain_numpy(cfg: PipelineConfig, raw: np.ndarray,
                          bp_in: Optional[np.ndarray] = None) -> dict:
    """Slow, direct numpy oracle of the *unweighted* chain for tests:
    convert -> rfft -> |.|^2 -> EMA bandpass -> pscrunch -> tscrunch ->
    quantize levels (unpacked).  Mirrors the same math as process_segment
    with rfi_mode=0 for flag-free data."""
    npol, nsamp = raw.shape
    x = raw.astype(np.float32) / 128.0 - 1.0
    x[raw == 0] = 0.0
    spec = np.fft.rfft(x.reshape(npol, -1, cfg.nfft), axis=-1)
    p = (spec.real ** 2 + spec.imag ** 2).astype(np.float32)
    ntime = p.shape[1]
    bp = np.zeros((npol, cfg.nchan), np.float32) if bp_in is None else bp_in.copy()
    out = np.empty_like(p)
    seg = cfg.ffts_per_seg
    for s in range(0, ntime, seg):
        blk = p[:, s:s + seg]
        mask = bp == 0.0
        bp[mask] = np.mean(blk, axis=1)[mask]
        for t in range(blk.shape[1]):
            bp = (cfg.bp_scale * blk[:, t] + (1 - cfg.bp_scale) * bp).astype(np.float32)
            out[:, s + t] = blk[:, t] / bp - 1.0
    if cfg.npol_out == 1 and npol == 2:
        out = (np.sqrt(np.float32(0.5)) * (out[0] + out[1]))[None]
    ns = cfg.nscrunch
    out = out.reshape(out.shape[0], -1, ns, cfg.nchan).sum(2) * np.float32(
        1.0 / np.sqrt(ns))
    trimmed = out[:, :, cfg.chanmin:cfg.chanmax + 1]
    return {"power": p, "normalized": out, "trimmed": trimmed, "bp": bp}
