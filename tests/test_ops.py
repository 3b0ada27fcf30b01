"""Golden-value unit tests for the DSP kernels vs numpy oracles
(the test pyramid the reference lacks, SURVEY.md section 4)."""

import numpy as np
import pytest
import jax.numpy as jnp

from vlite_fast import constants as C
from vlite_fast.ops import (channelize, injection, kurtosis, normalize,
                                quantize, unpack)


def test_convert_uint8():
    u = jnp.asarray(np.array([0, 1, 128, 255], dtype=np.uint8))
    f = np.asarray(unpack.convert_uint8(u))
    # 0 is a gap-fill flag and stays 0 (ref pb_kernels.cu:28-31)
    np.testing.assert_allclose(f, [0.0, 1 / 128 - 1, 0.0, 255 / 128 - 1],
                               rtol=1e-6)


def test_digitize_inverse():
    x = np.linspace(-3, 3, 100).astype(np.float32)
    u = np.asarray(unpack.digitize_uint8(jnp.asarray(x)))
    back = (u.astype(np.float32) - 128.5 + 0.5) * 0.02957 * 2
    err = back - x
    # correct rounding bounds the error at HALF an LSB with ~zero bias
    # (a full-LSB tolerance would admit a truncating/offset digitizer)
    assert np.abs(err).max() < 0.51 * 0.02957 * 2
    assert abs(err.mean()) < 0.05 * 0.02957 * 2


class TestKurtosis:
    def _data(self, seed=0, npol=2, nwin=40, nkurto=50):
        rng = np.random.default_rng(seed)
        return rng.standard_normal((npol, nwin * nkurto)).astype(np.float32)

    def test_window_stats_oracle(self):
        x = self._data()
        p, k = kurtosis.window_stats(jnp.asarray(x), 50)
        xw = x.reshape(2, -1, 50)
        m2 = (xw ** 2).mean(-1)
        m4 = (xw ** 4).mean(-1)
        np.testing.assert_allclose(np.asarray(p), m2, rtol=1e-5)
        np.testing.assert_allclose(np.asarray(k), m4 / m2 ** 2, rtol=1e-4)

    def test_zero_window(self):
        x = self._data()
        x[0, :50] = 0.0
        p, k = kurtosis.window_stats(jnp.asarray(x), 50)
        assert p[0, 0] == 0.0 and k[0, 0] == 0.0
        dag = kurtosis.dagostino_ts(k, 50)
        assert np.asarray(dag)[0] == C.DAG_INF

    def test_dagostino_gaussian_rate(self):
        # For Gaussian data the TS is ~N(0,1); with |TS| and pol-max the
        # 3-sigma flag rate should be small
        x = self._data(seed=1, nwin=20000)
        _, k = kurtosis.window_stats(jnp.asarray(x), 50)
        dag = np.asarray(kurtosis.dagostino_ts(k, 50))
        rate = (dag > C.DAG_THRESH).mean()
        # pol-maxed |N(0,1)|-like TS at 3 sigma: ~2 * 0.135% = ~0.27%.
        # The LOWER bound matters: a deflated TS (wrong constants) would
        # flag nothing and still pass a pure upper bound.
        assert 0.0005 < rate < 0.02

    def test_rfi_flagged_and_masked(self):
        x = self._data(seed=2, nwin=100)
        # blast one window with impulsive RFI in pol 0
        x[0, 500:550] += 20.0
        res = kurtosis.rfi_excise(jnp.asarray(x), nkurto=50, nfft=250)
        dag = np.asarray(res.dag)
        assert dag[10] > C.DAG_THRESH            # window 10 flagged
        m = np.asarray(res.masked)
        assert np.all(m[:, 500:550] == 0.0)      # both pols zeroed
        # weight of the affected FFT block (5 windows/block) drops by 1/5
        wts = np.asarray(res.weights)
        assert abs(wts[0, 2] - 0.8) < 1e-6
        # unaffected blocks keep weight 1
        assert wts[0, 0] == 1.0

    def test_debug_weights_mode(self):
        # deterministic validation mask (ref DEBUG_WEIGHTS,
        # pb_kernels.cu:258-265): pol1 loses its second half, pol0 its
        # final eighth
        x = self._data(seed=9, nwin=80)           # nsamp = 4000
        masked, w = kurtosis.apply_mask(jnp.asarray(x), jnp.zeros(80), 50,
                                        500, debug_weights=True)
        m, w = np.asarray(masked), np.asarray(w)
        assert np.all(m[1, 2050:] == 0.0)         # pol1 second half zeroed
        assert np.all(m[1, :2000] == x[1, :2000])
        assert np.all(m[0, 3550:] == 0.0)         # pol0 final eighth
        assert np.all(m[0, :3500] == x[0, :3500])
        # weights per FFT block (10 windows each) reflect the pattern
        assert w[1, 0] == 1.0 and w[1, -1] == 0.0
        assert 0 < w[0, -1] < 1.0

    def test_flag_mask_agreement_rate(self):
        """SURVEY section 6 'exactness of statistics': float32 accumulation
        order shifts TS values near threshold, so parity is defined as the
        flag-mask agreement rate vs a float64 oracle — require >99.9% on
        Gaussian data with injected RFI."""
        rng = np.random.default_rng(11)
        nkurto, nwin = 50, 4000
        x = rng.standard_normal((2, nwin * nkurto)).astype(np.float32)
        # sprinkle impulsive RFI
        for k in range(0, nwin * nkurto, 9173):
            x[0, k] += 30.0
        res = kurtosis.rfi_excise(jnp.asarray(x), nkurto=nkurto, nfft=250)
        flags_f32 = np.asarray(res.dag) >= C.DAG_THRESH

        # float64 oracle with the same formulas
        xw = x.astype(np.float64).reshape(2, nwin, nkurto)
        m2 = (xw ** 2).mean(-1)
        m4 = (xw ** 4).mean(-1)
        kur = np.where(m2 == 0, 0.0, m4 / np.where(m2 == 0, 1, m2 ** 2))
        k = C.dagostino_constants(nkurto)
        t = (1 - 2 / k["A"]) / (1 + (kur - 3 - k["mu1"]) * k["Z2_3"])
        dag = np.where(t > 0,
                       np.abs(k["Z2_1"] * (k["Z2_2"] - np.cbrt(
                           np.where(t > 0, t, 1)))), C.DAG_INF)
        dag = np.where(kur == 0, C.DAG_INF, dag)
        flags_f64 = dag.max(axis=0) >= C.DAG_THRESH
        agreement = (flags_f32 == flags_f64).mean()
        assert agreement > 0.999, agreement
        # and the RFI windows are flagged in both
        assert flags_f32[0] and flags_f64[0]

    def test_fake_mode(self):
        x = self._data(seed=3)
        masked, w = kurtosis.apply_mask(jnp.asarray(x), jnp.zeros(40), 50,
                                        250, fake=True)
        np.testing.assert_array_equal(np.asarray(masked), x)
        assert np.all(np.asarray(w) == 1.0)


class TestNormalize:
    def test_ema_oracle(self):
        rng = np.random.default_rng(0)
        p = rng.chisquare(2, (2, 32, 16)).astype(np.float32)
        bp0 = np.zeros((2, 16), np.float32)
        out, bp = normalize.normalize_ema(jnp.asarray(p), jnp.asarray(bp0),
                                          0.01)
        # numpy oracle
        bp_ref = p.mean(axis=1)
        out_ref = np.empty_like(p)
        for t in range(32):
            bp_ref = 0.01 * p[:, t] + 0.99 * bp_ref
            out_ref[:, t] = p[:, t] / bp_ref - 1
        np.testing.assert_allclose(np.asarray(out), out_ref, rtol=2e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(bp), bp_ref, rtol=2e-4,
                                   atol=1e-6)

    def test_ema_weighted_clip_and_zero(self):
        # long enough that a lone spike doesn't trip the stale-bandpass
        # re-seed (a single clip event has ~1/T leverage on the chunk mean)
        p = np.ones((1, 64, 4), np.float32)
        w = np.ones((1, 64), np.float32)
        w[0, 3] = 0.0            # dead spectrum
        p[0, 40, :] = 100.0      # clipped spectrum (>11x bandpass of ~1)
        out, bp = normalize.normalize_ema_weighted(
            jnp.asarray(p), jnp.asarray(w), jnp.ones((1, 4)), 0.01)
        out = np.asarray(out)
        assert np.all(out[0, 3] == 0.0)                 # w=0 -> 0
        assert np.all(out[0, 40] == C.BP_CLIP_VALUE)    # clip -> 10
        # the clipped spectrum never updates the bandpass
        assert abs(float(np.asarray(bp)[0, 0]) - 1.0) < 1e-4
        # good unit-power spectra normalize to ~0
        assert np.all(np.abs(out[0, 63]) < 1e-4)

    def test_stale_bandpass_reseeds_after_gap(self):
        # a carried bandpass 5x+ off the chunk mean (e.g. after a
        # gap-filled second left bp at the fallback value) re-seeds
        # immediately instead of crawling for seconds (divergence from the
        # reference's acknowledged stuck-bandpass TODO,
        # pb_kernels.cu:488-494)
        rng = np.random.default_rng(6)
        p = rng.chisquare(2, (1, 256, 8)).astype(np.float32) * 4.0
        w = np.ones((1, 256), np.float32)
        out, bp = normalize.normalize_ema_weighted(
            jnp.asarray(p), jnp.asarray(w), jnp.full((1, 8), 0.1), 0.002)
        out = np.asarray(out)
        # normalized output is centered near zero right away
        assert abs(out[0, 10:].mean()) < 0.5
        assert np.asarray(bp).mean() > 2.0

    def test_assoc_matches_scan(self):
        rng = np.random.default_rng(2)
        p = rng.chisquare(2, (2, 64, 16)).astype(np.float32)
        bp0 = np.zeros((2, 16), np.float32)
        o1, b1 = normalize.normalize_ema(jnp.asarray(p), jnp.asarray(bp0),
                                         0.02)
        o2, b2 = normalize.normalize_ema_assoc(jnp.asarray(p),
                                               jnp.asarray(bp0), 0.02)
        np.testing.assert_allclose(np.asarray(o1), np.asarray(o2),
                                   rtol=5e-4, atol=5e-5)
        np.testing.assert_allclose(np.asarray(b1), np.asarray(b2),
                                   rtol=5e-4)

    def test_assoc_weighted_matches_scan(self):
        rng = np.random.default_rng(3)
        p = rng.chisquare(2, (2, 64, 16)).astype(np.float32)
        p[0, 20] *= 100.0                # clip event
        w = np.ones((2, 64), np.float32)
        w[:, 10] = 0.0                   # dead spectrum
        w[1, 30:35] = 0.5
        bp0 = np.zeros((2, 16), np.float32)
        o1, b1 = normalize.normalize_ema_weighted(
            jnp.asarray(p), jnp.asarray(w), jnp.asarray(bp0), 0.02)
        o2, b2 = normalize.normalize_ema_weighted_assoc(
            jnp.asarray(p), jnp.asarray(w), jnp.asarray(bp0), 0.02)
        np.testing.assert_allclose(np.asarray(o1), np.asarray(o2),
                                   rtol=2e-3, atol=1e-3)
        np.testing.assert_allclose(np.asarray(b1), np.asarray(b2),
                                   rtol=2e-3)

    def test_framed_rfi_matches_flat(self):
        """rfi_excise_framed (the frame-layout front that avoids the f32
        tile relayouts — see its docstring) must agree with rfi_excise:
        identical weights and masked voltages, stats to f32 rounding."""
        from vlite_fast.ops import channelize as ch
        from vlite_fast.ops.unpack import convert_uint8

        npol, nspec, nfft, nkurto = 2, 4, 500, 50
        rng = np.random.default_rng(5)
        raw = np.clip(rng.standard_normal((npol, nspec * nfft)) / 0.059
                      + 128.5, 0, 255).astype(np.uint8)
        # an RFI burst that must flag
        raw[0, 300:350] = np.clip(
            128.5 + 60 * np.sign(rng.standard_normal(50)), 0,
            255).astype(np.uint8)
        x = convert_uint8(jnp.asarray(raw))
        res = kurtosis.rfi_excise(x, nkurto, nfft)
        n1, n2 = ch._ct_split(nfft)
        xb = jnp.asarray(raw.reshape(npol * nspec, n1, n2))
        fr = kurtosis.rfi_excise_framed(xb, npol, nkurto, nfft)
        np.testing.assert_allclose(np.asarray(fr.pow_w),
                                   np.asarray(res.pow_w), rtol=1e-6)
        np.testing.assert_allclose(np.asarray(fr.kur_w),
                                   np.asarray(res.kur_w), rtol=1e-5)
        np.testing.assert_array_equal(np.asarray(fr.weights),
                                      np.asarray(res.weights))
        assert np.asarray(fr.weights).min() < 1.0  # the burst flagged
        masked = np.asarray(
            jnp.where(fr.row_keep[:, :, None], fr.xf, 0.0)
        ).reshape(npol, nspec * nfft)
        np.testing.assert_array_equal(masked, np.asarray(res.masked))

    def test_framed_dft_matches_planes(self):
        from vlite_fast.ops import channelize as ch
        nfft = 500
        n1, n2 = ch._ct_split(nfft)
        rng = np.random.default_rng(6)
        x = (rng.integers(-128, 128, (2, 3, nfft)) / 128.0
             ).astype(np.float32)
        a = ch.matmul_rfft_planes(jnp.asarray(x), nfft,
                                  precision="highest")
        b = ch.matmul_rfft_framed(
            jnp.asarray(x.reshape(6, n1, n2)), nfft,
            precision="highest").reshape(2, 3, -1)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_matmul_matches_scan(self):
        """The matmul affine scan (ops/normalize._affine_scan_matmul, the
        chain default — replaces associative_scan's pad/slice tree with
        two lower-triangular matmuls) agrees with the sequential scan to
        f32 rounding, including the bp==0 seed path."""
        rng = np.random.default_rng(2)
        p = rng.chisquare(2, (2, 64, 16)).astype(np.float32)
        bp0 = np.zeros((2, 16), np.float32)
        o1, b1 = normalize.normalize_ema(jnp.asarray(p), jnp.asarray(bp0),
                                         0.02)
        o2, b2 = normalize.normalize_ema_matmul(jnp.asarray(p),
                                                jnp.asarray(bp0), 0.02)
        np.testing.assert_allclose(np.asarray(o1), np.asarray(o2),
                                   rtol=5e-4, atol=5e-5)
        np.testing.assert_allclose(np.asarray(b1), np.asarray(b2),
                                   rtol=5e-4)

    def test_matmul_weighted_matches_scan(self):
        rng = np.random.default_rng(3)
        p = rng.chisquare(2, (2, 64, 16)).astype(np.float32)
        p[0, 20] *= 100.0                # clip event
        w = np.ones((2, 64), np.float32)
        w[:, 10] = 0.0                   # dead spectrum
        w[1, 30:35] = 0.5
        bp0 = np.zeros((2, 16), np.float32)
        o1, b1 = normalize.normalize_ema_weighted(
            jnp.asarray(p), jnp.asarray(w), jnp.asarray(bp0), 0.02)
        o2, b2 = normalize.normalize_ema_weighted_matmul(
            jnp.asarray(p), jnp.asarray(w), jnp.asarray(bp0), 0.02)
        np.testing.assert_allclose(np.asarray(o1), np.asarray(o2),
                                   rtol=2e-3, atol=1e-3)
        np.testing.assert_allclose(np.asarray(b1), np.asarray(b2),
                                   rtol=2e-3)

    def test_pscrunch(self):
        x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
        out = np.asarray(normalize.pscrunch(jnp.asarray(x)))
        np.testing.assert_allclose(out[0], (x[0] + x[1]) * np.sqrt(0.5),
                                   rtol=1e-6)

    def test_pscrunch_weights_cases(self):
        x = np.ones((2, 3, 2), np.float32)
        x[1] *= 3.0
        w = np.array([[1.0, 1.0, 0.1], [1.0, 0.1, 0.1]], np.float32)
        out, wc = normalize.pscrunch_weights(jnp.asarray(x), jnp.asarray(w))
        out, wc = np.asarray(out), np.asarray(wc)
        np.testing.assert_allclose(out[0, 0], 4 * np.sqrt(0.5), rtol=1e-6)
        np.testing.assert_allclose(out[0, 1], 1.0)   # only pol0 good
        np.testing.assert_allclose(out[0, 2], 0.0)   # none good
        np.testing.assert_allclose(wc[0], [1.0, 1.0, 0.0])

    def test_tscrunch(self):
        x = np.arange(16, dtype=np.float32).reshape(1, 8, 2)
        out = np.asarray(normalize.tscrunch(jnp.asarray(x), 4))
        ref = x.reshape(1, 2, 4, 2).sum(2) / 2.0
        np.testing.assert_allclose(out, ref, rtol=1e-6)

    def test_tscrunch_weights(self):
        x = np.ones((1, 8, 2), np.float32)
        w = np.ones((1, 8), np.float32)
        w[0, :3] = 0.1           # below MIN_WEIGHT
        out = np.asarray(normalize.tscrunch_weights(jnp.asarray(x),
                                                    jnp.asarray(w), 4))
        # first group: 1 good sample of weight 1 -> sum=1, mean w = 1.3/4 <
        # MIN_WEIGHT? (0.1*3+1)/4 = 0.325 >= 0.2 -> keep: 1/sqrt(1)
        np.testing.assert_allclose(out[0, 0], 1.0)
        np.testing.assert_allclose(out[0, 1], 4 / 2.0)


class TestQuantize:
    def test_levels_2bit(self):
        x = jnp.asarray(np.array([[-1.0, -0.6109, -0.61, 0.396, 0.397,
                                   1.40, 1.41, 5.0]], np.float32)[None])
        lev = np.asarray(quantize.quantize_2bit(x))
        np.testing.assert_array_equal(lev[0, 0],
                                      [0, 1, 1, 1, 2, 2, 3, 3])

    def test_pack_unpack_roundtrip(self):
        rng = np.random.default_rng(0)
        for nbit in (2, 4, 8):
            lev = rng.integers(0, 2 ** nbit, (5, 16)).astype(np.uint8)
            p = quantize.pack_bits(jnp.asarray(lev), nbit)
            u = np.asarray(quantize.unpack_bits(p, nbit))
            np.testing.assert_array_equal(u, lev)

    def test_pack_bit_order(self):
        # sample j occupies bits [nbit*j] — LSB first (ref pb_kernels.cu:662)
        lev = jnp.asarray(np.array([[1, 0, 0, 0]], np.uint8))
        assert int(np.asarray(quantize.pack_bits(lev, 2))[0, 0]) == 1
        lev = jnp.asarray(np.array([[0, 0, 0, 3]], np.uint8))
        assert int(np.asarray(quantize.pack_bits(lev, 2))[0, 0]) == 3 << 6

    def test_sel_and_dig_layout(self):
        # 2 pol, 2 times, chans 1..4 retained, 8-bit: layout [t][pol][chan]
        x = np.zeros((2, 2, 6), np.float32)
        x[0, 0, 1] = 1.0   # pol0,t0,chan1
        x[1, 1, 4] = 1.0   # pol1,t1,chan4
        out = np.asarray(quantize.sel_and_dig(jnp.asarray(x), 1, 4, 8))
        assert out.shape == (2, 8)
        v = int(1.0 / C.QUANT8_SCALE + C.QUANT8_OFFSET)
        assert out[0, 0] == v          # t0 pol0 chan0(=abs 1)
        assert out[1, 4 + 3] == v      # t1 pol1 chan3(=abs 4)


def test_channelize_matches_rfft_small():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4 * 256)).astype(np.float32)
    spec = np.asarray(channelize.channelize(jnp.asarray(x), 256))
    assert spec.shape == (2, 4, 129)
    ref = np.fft.rfft(x.reshape(2, 4, 256), axis=-1)
    np.testing.assert_allclose(spec, ref, rtol=1e-3, atol=1e-3)


def test_matmul_rfft_matches_fft():
    rng = np.random.default_rng(2)
    for nfft in (500, 12500 // 5, 144):
        x = rng.standard_normal((3, 2 * nfft)).astype(np.float32)
        a = np.asarray(channelize.channelize(jnp.asarray(x), nfft,
                                             method="matmul"))
        ref = np.fft.rfft(x.reshape(3, 2, nfft), axis=-1)
        scale = np.abs(ref).max()
        np.testing.assert_allclose(a / scale, ref / scale, atol=2e-5)


def test_matmul_rfft_planes_matches_fft():
    # the real/imag-plane formulation must be numerically equivalent to
    # the complex-einsum one (same Cooley-Tukey factorization)
    rng = np.random.default_rng(3)
    for nfft in (500, 12500 // 5, 144):
        x = rng.standard_normal((3, 2, nfft)).astype(np.float32)
        a = np.asarray(channelize.matmul_rfft_planes(jnp.asarray(x), nfft))
        ref = np.fft.rfft(x, axis=-1)
        scale = np.abs(ref).max()
        np.testing.assert_allclose(a / scale, ref / scale, atol=2e-5)


def test_polyphase_channelize_shape_and_leakage():
    rng = np.random.default_rng(1)
    nfft, ntap = 64, 4
    t = np.arange(32 * nfft)
    # pure tone centered on bin 10
    x = np.cos(2 * np.pi * 10.25 * t / nfft).astype(np.float32)[None]
    pfb = np.asarray(channelize.polyphase_channelize(jnp.asarray(x), nfft, ntap))
    fft = np.asarray(channelize.channelize(jnp.asarray(x), nfft))
    assert pfb.shape == (1, 32 - 3, 33)
    # PFB suppresses leakage into a far bin relative to plain FFT
    p_pfb = np.abs(pfb[0, 5]) ** 2
    p_fft = np.abs(fft[0, 5]) ** 2
    leak_pfb = p_pfb[20] / p_pfb[10]
    leak_fft = p_fft[20] / p_fft[10]
    assert leak_pfb < leak_fft * 0.1


def test_inject_frb_track():
    nchan, nspec = 32, 16
    delays = np.linspace(0, 30, nchan).astype(np.float32)
    spec = jnp.ones((1, nspec, nchan), jnp.complex64)
    out = np.asarray(injection.inject_frb(spec, jnp.asarray(delays), 0,
                                          frb_width_spectra=2.0, frb_amp=2.0))
    # channel 0: delay 0 -> spectra 0..2 boosted
    assert np.allclose(np.abs(out[0, 0:3, 0]), 2.0)
    assert np.allclose(np.abs(out[0, 3, 0]), 1.0)
    # last channel: delay 30 -> beyond this chunk except t>=30
    assert np.allclose(np.abs(out[0, :, -1]), 1.0)
    # advancing the clock brings the late channels into range
    out2 = np.asarray(injection.inject_frb(spec, jnp.asarray(delays), 28,
                                           2.0, 2.0))
    assert np.allclose(np.abs(out2[0, 2:5, -1]), 2.0)


def test_polyphase_matches_independent_wola_oracle():
    """polyphase_channelize vs a hand-rolled numpy WOLA: independently
    construct the sinc-Hamming prototype (normalized so sum(w^2)=nfft,
    i.e. white-noise power matches the plain FFT path), window ntap
    consecutive frames, sum taps, rfft.  Every other PFB test compares
    the implementation against itself."""
    rng = np.random.default_rng(6)
    nfft, ntap, nspec_raw = 200, 4, 10
    x = rng.standard_normal((1, nspec_raw * nfft)).astype(np.float32)
    got = np.asarray(channelize.polyphase_channelize(
        jnp.asarray(x), nfft, ntap))
    # independent oracle
    n = ntap * nfft
    t = (np.arange(n) - n / 2 + 0.5) / nfft
    w = np.sinc(t) * np.hamming(n)
    w = w * np.sqrt(nfft / np.sum(w ** 2))
    frames = x.reshape(1, nspec_raw, nfft)
    nspec = nspec_raw - (ntap - 1)
    ref = np.empty((1, nspec, nfft // 2 + 1), np.complex64)
    for j in range(nspec):
        wola = np.zeros(nfft, np.float64)
        for tap in range(ntap):
            wola += frames[0, j + tap] * w[tap * nfft:(tap + 1) * nfft]
        ref[0, j] = np.fft.rfft(wola)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got / scale, ref / scale, atol=3e-5)
    # white-noise power parity with the plain channelizer (the fixed
    # normalization; the old sum(w^2)=ntap*nfft ran exactly ntap x hot)
    big = rng.standard_normal((1, 60 * nfft)).astype(np.float32)
    p_pfb = float(np.mean(np.abs(np.asarray(
        channelize.polyphase_channelize(jnp.asarray(big), nfft, ntap)))**2))
    p_fft = float(np.mean(np.abs(np.asarray(
        channelize.channelize(jnp.asarray(big), nfft)))**2))
    assert abs(p_pfb / p_fft - 1.0) < 0.15
