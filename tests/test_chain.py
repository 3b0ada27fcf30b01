"""Per-antenna DSP chain tests on the tiny geometry (CPU)."""

import numpy as np
import pytest
import jax.numpy as jnp

from vlite_fast.config import PipelineConfig
from vlite_fast.models import baseband_dsp as dsp
from vlite_fast.models import synthesis
from vlite_fast.ops import quantize as q_ops

CFG = PipelineConfig.tiny()  # 1 Msps, nfft 500, nchan 251, 8-bit


def run_second(cfg, raw, state=None, arm=False):
    state = state or dsp.init_state(cfg)
    out, st = dsp.process_second(cfg, jnp.asarray(raw), state,
                                 jnp.asarray(arm))
    return out, st


def test_shapes_and_state():
    raw = synthesis.white_noise_uint8(CFG.sample_rate, seed=0)
    out, st = run_second(CFG, raw)
    nbytes = CFG.npol_out * CFG.nchanout * CFG.nbit // 8
    out_samps = CFG.seg_per_sec * CFG.out_samps_per_seg
    assert out.packed.shape == (out_samps, nbytes)
    assert out.packed_kur.shape == (out_samps, nbytes)
    assert np.all(np.asarray(st.bp) > 0)      # bandpass initialized
    assert np.all(np.asarray(st.bp_kur) > 0)


def test_dft_precision_validated():
    # pure-bf16 DFT matmuls are too inaccurate in isolated bins — the
    # config must reject them
    with pytest.raises(ValueError):
        PipelineConfig.tiny(dft_precision="default")
    for ok in ("high", "highest"):
        assert PipelineConfig.tiny(dft_precision=ok).dft_precision == ok


def test_batch_streams_parity():
    # the 2x-batched dual-stream DFT variant (a perf knob, off by
    # default) must produce the same packed
    # output as the sequential default.  ema_impl='assoc' (elementwise,
    # batch-invariant) makes byte-exactness well-defined here; the
    # default 'matmul' EMA lowers its dot differently under batching
    # (<=1e-4 single-level flips, see test_ema_matmul_near_exact)
    raw = synthesis.white_noise_uint8(CFG.sample_rate, seed=9)
    out_a, _ = run_second(PipelineConfig.tiny(ema_impl="assoc"), raw)
    out_b, _ = run_second(PipelineConfig.tiny(batch_streams=True,
                                              ema_impl="assoc"), raw)
    np.testing.assert_array_equal(np.asarray(out_a.packed),
                                  np.asarray(out_b.packed))
    np.testing.assert_array_equal(np.asarray(out_a.packed_kur),
                                  np.asarray(out_b.packed_kur))


def test_front_layout_parity():
    """The frame-layout fronts (perf knobs, off by default — see
    config.front_layout) produce byte-identical
    packed output to the default flat front: they differ only in where
    the layout reshape happens (uint8 vs f32) and in window-sum order,
    which the masked voltages prove equal end to end."""
    raw = synthesis.white_noise_uint8(CFG.sample_rate, seed=3)
    ol, _ = run_second(PipelineConfig.tiny(front_layout="flat"), raw)
    for layout in ("frames", "mixed"):
        of, _ = run_second(PipelineConfig.tiny(front_layout=layout), raw)
        np.testing.assert_array_equal(np.asarray(of.packed),
                                      np.asarray(ol.packed))
        np.testing.assert_array_equal(np.asarray(of.packed_kur),
                                      np.asarray(ol.packed_kur))
        np.testing.assert_array_equal(np.asarray(of.weights),
                                      np.asarray(ol.weights))


def test_ema_matmul_near_exact():
    """The production default ema_impl='matmul' trades strict
    cross-context bit-exactness for speed: its lower-triangular dot lowers differently under
    vmap/batching, wobbling the bandpass by ~1 ulp.  Contract: vs the
    'assoc' chain, >= 99.99% of packed bytes equal and every differing
    sample moves by at most ONE quantizer level."""
    raw = synthesis.white_noise_uint8(CFG.sample_rate, seed=9)
    out_m, _ = run_second(PipelineConfig.tiny(ema_impl="matmul"), raw)
    out_a, _ = run_second(PipelineConfig.tiny(ema_impl="assoc"), raw)
    for field in ("packed", "packed_kur"):
        m = np.asarray(getattr(out_m, field)).astype(np.int16)
        a = np.asarray(getattr(out_a, field)).astype(np.int16)
        # tiny config quantizes to 8 bits (256 dense levels), so ~1 ulp
        # of bandpass wobble flips more samples than production's 2-bit
        assert (m == a).mean() > 0.999, field
        assert np.abs(m - a).max() <= 1, field


def test_noise_statistics():
    # on flag-free white noise the normalized+quantized output should be
    # centered near the 8-bit zero level (127.5) with std ~1/0.02957 scaled
    raw = synthesis.white_noise_uint8(CFG.sample_rate, seed=1)
    out, st = run_second(CFG, raw)
    lev = np.asarray(out.packed_kur).astype(np.float32)
    assert abs(lev.mean() - 127.5) < 3.0
    # normalized samples have std 1 -> quantized std 1/0.02957 ~ 33.8,
    # clipped slightly by the 8-bit range
    assert 20 < lev.std() < 40
    # kurtosis weights should be ~all good on Gaussian noise
    assert np.asarray(out.weights).mean() > 0.95


def test_parity_with_numpy_oracle():
    cfg = PipelineConfig.tiny(rfi_mode=0)
    raw = synthesis.white_noise_uint8(cfg.sample_rate, seed=2)
    out, st = run_second(cfg, raw)
    ref = dsp.reference_chain_numpy(cfg, raw)
    lev_ref = np.asarray(q_ops.quantize_8bit(jnp.asarray(ref["trimmed"])))
    lev_ref = lev_ref[0]  # npol_out=1
    lev = np.asarray(out.packed)
    assert lev.shape == lev_ref.shape
    # agreement up to quantization-edge rounding
    frac_equal = (lev == lev_ref).mean()
    assert frac_equal > 0.99
    assert np.abs(lev.astype(int) - lev_ref.astype(int)).max() <= 1


def test_state_carry_across_seconds():
    raw1 = synthesis.white_noise_uint8(CFG.sample_rate, seed=3)
    raw2 = synthesis.white_noise_uint8(CFG.sample_rate, seed=4)
    out1, st1 = run_second(CFG, raw1)
    out2, st2 = run_second(CFG, raw2, state=st1)
    # bandpass evolves but stays near the seed
    bp1, bp2 = np.asarray(st1.bp), np.asarray(st2.bp)
    assert not np.array_equal(bp1, bp2)
    assert np.allclose(bp1, bp2, rtol=0.5)


def test_rfi_burst_excised():
    raw = synthesis.white_noise_uint8(CFG.sample_rate, seed=5)
    # 2 ms of strong impulsive RFI in both pols — a pure variance step
    # would NOT trip a kurtosis detector; RFI is flagged by its
    # non-Gaussianity (sparse impulses => kurtosis >> 3)
    burst = synthesis.white_noise_uint8(2000, npol=1, seed=6)[0].copy()
    burst[::10] = 255
    raw = raw.copy()
    raw[:, 10_000:12_000] = burst
    out, st = run_second(CFG, raw)
    w = np.asarray(out.weights)
    # the affected spectra (samples 10000-12000 -> spectra 20..24) lose weight
    assert w[0, 20:24].mean() < 0.2
    assert w[0, 50:].mean() > 0.95
    assert float(out.dag_frac) < 0.05


def test_frb_injection_recovered():
    cfg = PipelineConfig.tiny(inject_frb=True, inject_dm=0.0,
                              inject_amp=1.5, inject_width_s=10e-3)
    raw0 = synthesis.white_noise_uint8(cfg.sample_rate, seed=6)
    raw = synthesis.white_noise_uint8(cfg.sample_rate, seed=7)
    # establish the bandpass on a clean second, then arm the injection
    # (matching production: the 60 s injection cadence never coincides with
    # the bandpass seed block, ref process_baseband.cu:1098)
    _, st0 = run_second(cfg, raw0)
    out_inj, _ = run_second(cfg, raw, state=st0, arm=True)
    _, st0b = run_second(cfg, raw0)
    out_ref, _ = run_second(cfg, raw, state=st0b, arm=False)
    li = np.asarray(out_inj.packed_kur).astype(np.float32)
    lr = np.asarray(out_ref.packed_kur).astype(np.float32)
    # DM 0: burst hits all channels in the first 10 ms (first 5 out samples)
    assert (li[:5] - lr[:5]).mean() > 5.0
    assert abs((li[50:] - lr[50:]).mean()) < 2.0


def test_all_zero_second_is_finite():
    """A fully gap-filled (all-zero) second must not poison the chain with
    NaNs, and the next real second must recover."""
    zero = np.zeros((2, CFG.sample_rate), np.uint8)
    out0, st = run_second(CFG, zero)
    for arr in (out0.packed, out0.packed_kur):
        assert np.isfinite(np.asarray(arr).astype(np.float64)).all()
    assert np.isfinite(np.asarray(st.bp)).all()
    assert np.isfinite(np.asarray(st.bp_kur)).all()
    # kurtosis flags the dead windows entirely
    assert np.asarray(out0.weights).max() == 0.0
    raw = synthesis.white_noise_uint8(CFG.sample_rate, seed=13)
    out1, st = run_second(CFG, raw, state=st)
    lev = np.asarray(out1.packed_kur).astype(np.float32)
    assert np.isfinite(lev).all()
    assert abs(lev[50:].mean() - 127.5) < 4.0   # normal operation resumes


def test_pfb_channelizer_chain():
    """Streaming WOLA polyphase variant (BASELINE configs[1]): spectra
    must match the offline PFB applied to the concatenated stream."""
    import jax.numpy as jnp
    from vlite_fast.ops import channelize as ch_ops
    cfg = PipelineConfig.tiny(channelizer="pfb", rfi_mode=0, pfb_ntap=4)
    raw = synthesis.white_noise_uint8(2 * cfg.sample_rate, seed=12)
    st = dsp.init_state(cfg)
    assert st.tail.shape == (2, 2, 3 * cfg.nfft)
    outs = []
    for k in range(2):
        out, st = dsp.process_second(
            cfg, jnp.asarray(raw[:, k * cfg.sample_rate:
                                 (k + 1) * cfg.sample_rate]), st,
            jnp.asarray(False))
        outs.append(np.asarray(out.packed))
    got = np.concatenate(outs, axis=0).astype(np.float32)

    # oracle: offline PFB over the whole stream with (ntap-1)*nfft zero
    # padding in front (the cold-start tail)
    from vlite_fast.ops import unpack as unpack_ops
    x = np.asarray(unpack_ops.convert_uint8(jnp.asarray(raw)))
    x_ext = np.concatenate(
        [np.zeros((2, 3 * cfg.nfft), np.float32), x], axis=1)
    spec = np.asarray(ch_ops.polyphase_channelize(
        jnp.asarray(x_ext), cfg.nfft, 4))
    ref = dsp.reference_chain_numpy  # noqa: F841 (structure reference)
    # compare detected+normalized+quantized via the same tail ops
    from vlite_fast.ops import normalize as norm_ops
    from vlite_fast.ops import quantize as q_ops
    p = (np.abs(spec) ** 2).astype(np.float32)
    # per-second EMA with seg-boundary semantics: run the same chain fn
    bp = jnp.zeros((2, cfg.nchan), jnp.float32)
    blocks = []
    seg = cfg.ffts_per_seg
    for s in range(p.shape[1] // seg):
        blk = jnp.asarray(p[:, s * seg:(s + 1) * seg])
        o, bp = norm_ops.normalize_ema_assoc(blk, bp, cfg.bp_scale)
        o = norm_ops.pscrunch(o)
        o = norm_ops.tscrunch(o, cfg.nscrunch)
        blocks.append(np.asarray(q_ops.sel_and_dig(
            o, cfg.chanmin, cfg.chanmax, cfg.nbit)))
    ref_packed = np.concatenate(blocks, axis=0).astype(np.float32)
    match = (got == ref_packed).mean()
    assert match > 0.99, f"only {match:.3f} of samples equal"


def test_npol2_output():
    cfg = PipelineConfig.tiny(npol_out=2, nbit=4)
    raw = synthesis.white_noise_uint8(cfg.sample_rate, seed=8)
    out, st = run_second(cfg, raw)
    nbytes = 2 * cfg.nchanout * 4 // 8
    assert out.packed.shape == (cfg.seg_per_sec * cfg.out_samps_per_seg,
                                nbytes)
