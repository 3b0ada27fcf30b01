"""Analytic cost models + the peak table that utilization is read against.

Grounds the real-time factors in hardware numbers: how many FLOP/s and
bytes/s the chain moves, against the card's published peaks.  Peaks are
keyed by JAX's `device_kind`; a device that is not in the table is an
error, not a default.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover
    from vlite_fast.config import PipelineConfig

# Published dense peaks (no sparsity) at the card's full power limit.
# Source: NVIDIA H100 Tensor Core GPU data sheet, SXM5 part.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_tflops": 989.0,
        "tf32_tflops": 495.0,
        "hbm_gbps": 3350.0,
        "power_w": 700.0,
        "source": "NVIDIA H100 data sheet (SXM5, dense)",
    },
}


def peaks(device_kind: str) -> dict:
    """The PEAKS row for a JAX device_kind; unknown devices raise."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no published peaks for device_kind "
                       f"{device_kind!r}; add a sourced row to "
                       "utils/perf.PEAKS") from None


def dft_flops_per_data_second(cfg: "PipelineConfig") -> dict:
    """Matmul work of the Cooley-Tukey DFT (ops/channelize.matmul_rfft_
    planes) per second of dual-pol baseband.

    Per frame of nfft real samples (n1 x n2 split, n2_out = n2//2 + 1):
      stage 1: 2 real einsums (b,n1,n2)x(n1,n1) -> 4*n1^2*n2 flops
      stage 2: 4 real einsums (b,n1,n2)x(n2,n2_out) -> 8*n1*n2*n2_out
    dft_precision='high' runs each f32 matmul as 3 bf16 passes
    (DotAlgorithmPreset.BF16_BF16_F32_X3, ops/channelize.dot_precision),
    so hardware bf16 flops = 3x nominal.
    """
    from vlite_fast.ops.channelize import _ct_split
    n1, n2 = _ct_split(cfg.nfft)
    n2_out = n2 // 2 + 1
    per_frame = 4 * n1 * n1 * n2 + 8 * n1 * n2 * n2_out
    frames = cfg.npol_in * (cfg.sample_rate // cfg.nfft)
    nominal = per_frame * frames
    passes = 3 if getattr(cfg, "dft_precision", "high") == "high" else 1
    return {"nominal_flops": nominal, "hw_bf16_flops": nominal * passes}


def chain_hbm_bytes_per_data_second(cfg: "PipelineConfig") -> int:
    """Lower-bound device-memory traffic of the DSP chain per data-second: every
    major intermediate written+read once (XLA fuses the smaller
    elementwise stages; this counts the unavoidable materializations:
    raw bytes in, f32 voltages, spectra, detected/normalized powers,
    scrunched output, packed bytes out)."""
    nsamp = cfg.npol_in * cfg.sample_rate
    nspec = cfg.npol_in * (cfg.sample_rate // cfg.nfft)
    nchan = cfg.nfft // 2 + 1
    raw = nsamp                                   # uint8 read
    f32 = 2 * 4 * nsamp                           # write + read
    spec = 2 * 8 * nspec * nchan                  # complex64 w+r
    det = 2 * 4 * nspec * nchan                   # detected powers w+r
    out = cfg.seg_per_sec * cfg.out_samps_per_seg * cfg.nchanout \
        * cfg.nbit // 8
    return raw + f32 + spec + det + out


def xla_cost(jitted, *args) -> dict:
    """Best-effort XLA cost analysis of a jitted callable (flops +
    bytes accessed); {} when the backend doesn't support it."""
    try:
        c = jitted.lower(*args).compile().cost_analysis()
        if isinstance(c, (list, tuple)):
            c = c[0]
        return {k: float(v) for k, v in c.items()
                if k in ("flops", "bytes accessed")}
    except Exception:
        return {}
