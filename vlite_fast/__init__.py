"""vlite_fast — a real-time radio-transient detection framework in JAX.

A from-scratch rebuild of the capabilities of kerrm/vlite-fast, running on
NVIDIA H100 cards (one, or the four of one host): the per-antenna baseband DSP chain
(VDIF unpack -> FFT channelization -> spectral-kurtosis RFI excision ->
bandpass normalization -> pol/time scrunch -> re-quantization), the
incoherent-dedispersion single-pulse search (the role heimdall plays in the
reference), cross-antenna coincidence + triggering, the multi-antenna coadd,
and triggered voltage dumps — implemented as JAX/XLA + Pallas kernels over
time-frequency blocks, sharded with jax.sharding over (antenna, time) meshes,
with a host-side runtime replacing the reference's PSRDADA/multicast/MPI
process mesh.

Layer map (see SURVEY.md for the reference's layer map this mirrors):
  utils/     — formats & substrate: VDIF, sigproc, time, typed config
  ops/       — the DSP math as JAX ops and one Pallas (Triton) kernel
               (ref: src/pb_kernels.cu)
  models/    — composed signal-chain models (ref: src/process_baseband.cu,
               genbase.cu, heimdall's search role)
  parallel/  — mesh/sharding/collectives (ref: agdadacoadd MPI coadd)
  runtime/   — host-side capture/ring/trigger/control plane (ref: writer.c,
               messenger.c, dumper.c, trigger.py)
  analysis/  — offline voltage-domain analysis (ref: analysis/*.py)
"""

__version__ = "0.1.0"

from vlite_fast import constants  # noqa: F401
from vlite_fast.config import PipelineConfig, SearchConfig, ArrayConfig  # noqa: F401
