"""Per-stage timing of the production DSP chain on the card: times
progressively larger prefixes of the chain so stage costs fall out by
differencing (the PROFILE build-flag role,
ref process_baseband.h:9-13 + :1538-1565 end-of-obs breakdown)."""
import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time
import numpy as np
import jax, jax.numpy as jnp
from vlite_fast import backend
backend.enable_compile_cache()
from functools import partial
from vlite_fast.config import PipelineConfig
from vlite_fast.ops import channelize as ch
from vlite_fast.ops import kurtosis as kur
from vlite_fast.ops import normalize as norm
from vlite_fast.ops import quantize as q
from vlite_fast.ops import unpack as up
from vlite_fast.models import baseband_dsp as dsp

cfg = PipelineConfig()
dev = jax.devices()[0]
rng = np.random.default_rng(0)
raw = jax.device_put(np.clip(rng.standard_normal(
    (cfg.npol_in, cfg.sample_rate)) / 0.05914 + 128.5, 0, 255
    ).astype(np.uint8), dev)

def seconds(fn, reps=3):
    jax.block_until_ready(fn(raw))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(raw)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps

def scan_segs(body):
    def f(r):
        segs = r.reshape(cfg.npol_in, cfg.seg_per_sec,
                         cfg.seg_samps).swapaxes(0, 1)
        def step(c, seg):
            return c, body(seg)
        _, outs = jax.lax.scan(step, 0, segs)
        return outs
    return jax.jit(f)

t_unpack = seconds(scan_segs(lambda seg: jnp.sum(
    up.convert_uint8(seg), axis=-1)))
print(f"unpack only:           {t_unpack:.3f} s/s", flush=True)

t_fft = seconds(scan_segs(lambda seg: jnp.sum(jnp.abs(
    ch.channelize(up.convert_uint8(seg), cfg.nfft, method='matmul'))**2,
    axis=1)))
print(f"unpack+DFT(1 stream):  {t_fft:.3f} s/s", flush=True)

def kur_body(seg):
    x = up.convert_uint8(seg)
    res = kur.rfi_excise(x, cfg.nkurto, cfg.nfft,
                         dag_fb_thresh=cfg.dag_fb_thresh)
    return jnp.sum(res.masked, axis=-1), res.weights
t_kur = seconds(scan_segs(kur_body))
print(f"unpack+kurtosis:       {t_kur:.3f} s/s", flush=True)

cfg1 = PipelineConfig(rfi_mode=1)
st1 = jax.device_put(dsp.init_state(cfg1), dev)
t_m1 = seconds(lambda r: dsp.process_second(cfg1, r, st1,
                                            jnp.bool_(False))[0].packed_kur)
print(f"full chain rfi_mode=1: {t_m1:.3f} s/s", flush=True)

cfg2 = PipelineConfig()
st2 = jax.device_put(dsp.init_state(cfg2), dev)
t_m2 = seconds(lambda r: dsp.process_second(cfg2, r, st2,
                                            jnp.bool_(False))[0].packed_kur)
print(f"full chain rfi_mode=2: {t_m2:.3f} s/s", flush=True)
