"""Typed configuration for the VLITE-Fast pipeline.

Collapses the reference's three config tiers — compile-time #defines
(src/process_baseband.h), per-binary getopt flags (src/process_baseband.cu:
334-470), and the cluster tables (config/hosts, config/coadd parsed by
src/utils.c:421-457) — into dataclasses (SURVEY.md section 5 "Config").

All DSP geometry is parameterized so tests can run shrunken configurations on
CPU while production uses the reference geometry; defaults reproduce the
reference exactly.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Tuple

from vlite_fast import constants as C


@dataclass(frozen=True)
class PipelineConfig:
    """Per-antenna DSP chain geometry + options.

    Ref: compile-time constants src/process_baseband.h:16-57 and getopt flags
    src/process_baseband.cu:345-470 (npol -P, nbit -b, rfi_mode -r,
    inject -i).
    """

    sample_rate: int = C.VLITE_RATE        # real samples/s/pol
    npol_in: int = 2                       # input polarizations
    nfft: int = C.NFFT                     # channelizer transform length
    nscrunch: int = C.NSCRUNCH             # time-average factor
    seg_per_sec: int = C.SEG_PER_SEC       # processing chunks per second
    nkurto: int = C.NKURTO                 # fine kurtosis window
    chanmin: int = C.CHANMIN               # first retained channel (from DC)
    chanmax: int = C.CHANMAX               # last retained channel
    nbit: int = 2                          # output quantization (2/4/8)
    npol_out: int = 1                      # 1 = pscrunch, 2 = keep pols
    rfi_mode: int = 2                      # 0 none / 1 in-place / 2 dual-path
    inject_frb: bool = False
    inject_dm: float = C.INJECT_DM
    inject_width_s: float = C.INJECT_WIDTH_S
    inject_amp: float = C.INJECT_AMP
    # thresholds (ref src/process_baseband.h:35-46)
    ema_impl: str = "matmul"       # 'matmul' (affine scan as two small
                                   # lower-triangular matmuls, see
                                   # normalize._affine_scan_matmul; fuses
                                   # into detect->normalize->scrunch) |
                                   # 'assoc' (log-depth scan, batch-
                                   # invariant: the byte-exact dataflow
                                   # tests use it) | 'scan' (sequential
                                   # lax.scan).  All agree with the
                                   # sequential reference to f32 rounding
                                   # (tests/test_ops.py).
    channelizer: str = "matmul"    # 'matmul' (Cooley-Tukey DFT as two
                                   # batched matmul stages) | 'fft'
                                   # (XLA's FFT: cuFFT on the GPU, the
                                   # reference's own design) | 'pfb'
                                   # (streaming WOLA polyphase; sharper
                                   # channel response; works with every
                                   # rfi_mode — WOLA weight bookkeeping
                                   # via ops.channelize.pfb_weights).
                                   # chip_smoke.py times 'matmul' against
                                   # 'fft' on the card (PERF.md).
    pfb_ntap: int = 4              # polyphase taps when channelizer='pfb'
    batch_streams: bool = False    # rfi_mode=2: run both streams' DFT as
                                   # one 2x-batched call (the concat
                                   # doubles the live intermediate; off by
                                   # default, not yet timed on the GPU)
    dft_precision: str = "high"    # precision of the DFT matmuls:
                                   # 'high' (three bf16 passes, the
                                   # BF16_BF16_F32_X3 dot algorithm, ~4e-6
                                   # rel; held to >= 0.99998 of 2-bit
                                   # levels equal to the 'highest' CPU
                                   # oracle by chip_smoke.py.  Plain
                                   # Precision.HIGH runs TF32 on the H100
                                   # and misses that bar, PERF.md) |
                                   # 'highest' (full f32, ~1e-6 rel).
                                   # Pure bf16 ('default') is rejected:
                                   # too inaccurate in isolated bins.
    front_layout: str = "flat"     # 'flat' (default) | 'frames': reshape
                                   # the uint8 bytes ONCE into the DFT's
                                   # (b, n1, n2) Cooley-Tukey layout and
                                   # run convert/kurtosis/mask there
                                   # (kurtosis.rfi_excise_framed) |
                                   # 'mixed': stats flat, mask framed.
                                   # All three produce byte-identical
                                   # output (tested).
    dft_exact_input: bool = False  # exploit that 8-bit voltages are
                                   # EXACTLY bf16-representable: at
                                   # dft_precision='high', DFT stage 1
                                   # runs as 2 separate default-precision
                                   # passes against a hi/lo split of the
                                   # DFT matrix (the x_lo term of a
                                   # 3-pass bf16 product is identically
                                   # 0).  Off by default.
    dft_stage2: str = "direct"     # complex product form for the DFT's
                                   # second Cooley-Tukey stage: 'direct'
                                   # (4 real einsums; default) | 'gauss'
                                   # (the 3-multiplication trick: m1=(br+
                                   # bi)w2r, m2=br(w2i-w2r), m3=bi(w2i+
                                   # w2r) — one fewer matmul, ~equal
                                   # rounding, 99.994% 2-bit agreement).
    dag_thresh: float = C.DAG_THRESH
    dag_fb_thresh: float = C.DAG_FB_THRESH  # block-scale TS gate (live:
                                   # zero-weights whole FFT blocks; the
                                   # reference computes but comments out
                                   # this gate, pb_kernels.cu:255-256)
    do_histo: bool = False         # DOHISTO raw-sample histograms
                                   # (ref pb_kernels.cu:321-336)
    min_weight: float = C.MIN_WEIGHT
    bp_tsmooth: float = C.BP_TSMOOTH
    freq_top_mhz: float = C.FREQ_TOP_MHZ
    bandwidth_mhz: float = C.BANDWIDTH_MHZ

    # --- derived geometry -------------------------------------------------
    @property
    def nchan(self) -> int:
        return self.nfft // 2 + 1

    @property
    def nchanout(self) -> int:
        return self.chanmax - self.chanmin + 1

    @property
    def seg_samps(self) -> int:
        """Real samples per segment per polarization."""
        return self.sample_rate // self.seg_per_sec

    @property
    def ffts_per_seg(self) -> int:
        return self.seg_samps // self.nfft

    @property
    def windows_per_fft(self) -> int:
        return self.nfft // self.nkurto

    @property
    def nwin_per_seg(self) -> int:
        return self.seg_samps // self.nkurto

    @property
    def tsamp(self) -> float:
        """Output filterbank sampling interval [s]."""
        return self.nfft / self.sample_rate * self.nscrunch

    @property
    def tspec(self) -> float:
        """Raw (pre-scrunch) spectrum interval [s]."""
        return self.nfft / self.sample_rate

    @property
    def bp_scale(self) -> float:
        """EMA bandpass update weight (ref src/process_baseband.cu:737-741)."""
        return self.tsamp / self.bp_tsmooth

    @property
    def out_samps_per_seg(self) -> int:
        return self.ffts_per_seg // self.nscrunch

    @property
    def chan_bw_mhz(self) -> float:
        return -self.bandwidth_mhz / self.nchan

    @property
    def fch1_mhz(self) -> float:
        return self.freq_top_mhz + (self.chanmin - 0.5) * self.chan_bw_mhz

    def freqs_mhz(self):
        """Sky frequency of each RETAINED channel (chanmin..chanmax),
        channel centers, descending (negative chan_bw).  The single
        source of the channel->frequency mapping — runtime, sharded step,
        and tests must all use this (a convention fix in one copy-pasted
        site would otherwise be invisible to the others)."""
        import numpy as _np
        return self.freq_top_mhz + (
            _np.arange(self.chanmin, self.chanmax + 1) - 0.5
        ) * self.chan_bw_mhz

    def __post_init__(self):
        if self.seg_samps % self.nfft:
            raise ValueError("seg_samps must be a multiple of nfft")
        if self.nfft % self.nkurto:
            raise ValueError("nfft must be a multiple of nkurto")
        if self.ffts_per_seg % self.nscrunch:
            raise ValueError("ffts_per_seg must be a multiple of nscrunch")
        if self.nbit not in (2, 4, 8):
            raise ValueError("nbit must be 2, 4 or 8")
        if self.front_layout not in ("frames", "mixed", "flat"):
            raise ValueError(
                "front_layout must be 'frames', 'mixed' or 'flat'")
        if self.dft_stage2 not in ("direct", "gauss"):
            raise ValueError("dft_stage2 must be 'direct' or 'gauss'")
        if self.ema_impl not in ("matmul", "assoc", "scan"):
            raise ValueError("ema_impl must be 'matmul', 'assoc' or 'scan'")
        if self.batch_streams and self.channelizer == "pfb":
            # only the plain-DFT path implements the batched dual-stream
            # DFT; fail loudly rather than silently benchmarking the
            # sequential path
            raise ValueError("batch_streams requires channelizer != 'pfb'")
        if self.dft_precision not in ("highest", "high"):
            raise ValueError("dft_precision must be 'highest' or 'high' "
                             "(pure-bf16 'default' is too inaccurate)")
        if not 0 <= self.chanmin <= self.chanmax < self.nchan:
            raise ValueError(
                f"channel selection [{self.chanmin}, {self.chanmax}] "
                f"outside 0..{self.nchan - 1} (nfft {self.nfft})")
        samples_per_byte = 8 // self.nbit
        # per-ROW width is what pack_bits reshapes: the whole-segment
        # product can be byte-commensurate while a row is not
        if (self.nchanout * self.npol_out) % samples_per_byte:
            raise ValueError("channel/bit scheme is not byte-commensurate "
                             "(nchanout*npol_out must divide by "
                             f"{samples_per_byte} at {self.nbit}-bit; "
                             "ref src/process_baseband.cu:668-673)")

    @classmethod
    def tiny(cls, **overrides) -> "PipelineConfig":
        """A shrunken geometry for CPU tests: 12.5 kHz-rate analog."""
        kw = dict(
            sample_rate=1_000_000,  # 1 Msps
            nfft=500,
            nkurto=50,
            nscrunch=4,
            seg_per_sec=10,
            chanmin=16,
            chanmax=207,            # 192 output channels
            nbit=8,
        )
        kw.update(overrides)
        return cls(**kw)


@dataclass(frozen=True)
class SearchConfig:
    """Incoherent-dedispersion single-pulse search (heimdall's role).

    Ref invocation: scripts/start_heimdall_single_antenna:21
    (-nsamps_gulp 30720 -dm 2 1000 -boxcar_max 64 -zap_chans 0 190
     -zap_chans 3900 4096).
    """

    dm_min: float = 2.0
    dm_max: float = 1000.0
    ndm: int = 1024                # trial count for dm_grid_mode='linear'
    dm_grid_mode: str = "tol"      # 'tol': tolerance-driven trial placement
                                   # (heimdall/dedisp -dm_tol semantics,
                                   # scripts/start_heimdall_single_antenna
                                   # :21) — the production default; trial
                                   # count follows dm_tol.  'linear': ndm
                                   # fixed trials (tests/benchmarks).
    dm_tol: float = 1.25           # S/N loss tolerance setting the DM grid
    gulp_samps: int = 15360        # samples per search gulp (12 s).
                                   # The candidate-latency bound is gulp
                                   # + DM-1000 sweep = 20.8 s data-time,
                                   # less than half the reference's
                                   # 40-50 s (ref src/trigger.py:164-166;
                                   # heimdall used 24 s gulps,
                                   # scripts/start_heimdall_single_antenna:21).
                                   # Shorter gulps re-dedisperse the
                                   # DM-1000 overlap more often.
    boxcar_max: int = 64           # max matched-filter width (power-of-2 set)
    snr_thresh: float = 6.0        # per-beam candidate threshold
    zap_ranges: Tuple[Tuple[int, int], ...] = ((0, 190), (3900, 4096))
    max_candidates: int = 4096     # static candidate-buffer size per gulp
    cluster_radius: int = 8        # samples; merge nearby boxcar peaks
    engine: str = "auto"           # 'auto' (the platform's engine:
                                   # vlite_fast.backend.dedisp_engine) |
                                   # 'pallas' (ops/dedisperse_pallas:
                                   # two-stage shift-and-sum kernel, GPU
                                   # only) | 'subband' (XLA gathers) |
                                   # 'fourier' (dense phase ramps, FFTs)
    nsub: int = 128                # subbands in the two-stage decomposition
    nbatch: int = 128              # stage-1 DM batches (~4-sample worst-
                                   # case within-subband misalignment)
    topk: int = 0                  # device->host crossing slots per gulp;
                                   # 0 = min(16 * max_candidates, 20000)
    topk_dm_bands: int = 8         # the device->host top-k return is
                                   # quota'd per contiguous DM band (k/nbands
                                   # slots each) so an RFI storm saturating
                                   # the low-DM trials cannot evict a real
                                   # high-DM pulse from the fixed-size
                                   # return (heimdall's analogous guard is
                                   # its giant-cluster limits); falls back
                                   # to one global band when ndm isn't a
                                   # multiple.  Saturated bands are counted
                                   # (vfast_topk_saturated_total).

    @classmethod
    def tiny(cls, **overrides) -> "SearchConfig":
        kw = dict(dm_min=0.0, dm_max=100.0, ndm=64, gulp_samps=512,
                  boxcar_max=16, zap_ranges=(), max_candidates=256,
                  dm_grid_mode="linear")
        kw.update(overrides)
        return cls(**kw)

    @classmethod
    def low_latency(cls, **overrides) -> "SearchConfig":
        """6 s gulps instead of the default 12 s: the candidate-latency
        bound drops 20.8 -> 14.8 s data-time (gulp + DM-1000 overlap;
        the reference documents 40-50 s, src/trigger.py:164-166) and
        the voltage-dump margin against the 32-60 s ring depth widens
        correspondingly (scripts/start_writer:12).  The search costs more
        per data-second: the DM-1000 overlap is re-dedispersed every
        gulp — the trade a latency-sensitive deployment makes.
        """
        kw = dict(gulp_samps=7680)
        kw.update(overrides)
        return cls(**kw)


@dataclass(frozen=True)
class TriggerConfig:
    """Coincidencer cuts (ref src/trigger.py:45,148 and candidate.py:49-64)."""

    snr_thresh: float = C.TRIGGER_SNR
    # coadded-stream candidates carry the whole array's vote: no
    # min_beams cut, so the S/N bar is HIGHER to compensate for the
    # missing coincidence gate (see constants.TRIGGER_COADD_SNR)
    coadd_snr_thresh: float = C.TRIGGER_COADD_SNR
    min_beams: int = C.TRIGGER_MIN_BEAMS
    max_width_s: float = C.TRIGGER_MAX_WIDTH_S
    min_dm: float = C.TRIGGER_MIN_DM
    delta_dm: float = 0.1          # fractional DM agreement for overlap
    delta_w: float = 3.0           # max width ratio for overlap
    max_dump_s: float = C.MAX_DUMP_S
    buffer_pre_s: float = 0.1      # dump window padding (ref trigger.py:171)
    buffer_post_s: float = 0.2


@dataclass(frozen=True)
class AntennaConfig:
    """One antenna stream (one row of the reference's config/hosts table:
    hostname iface gpu ports keys ..., ref src/utils.c:421-457)."""

    station_id: int
    name: str = ""
    position_m: Tuple[float, float, float] = (0.0, 0.0, 0.0)  # ECEF-ish
    source: str = "udp:20000"    # station data source: 'udp:PORT' (live
                                 # VDIF datagrams), 'raw:IFACE:PORT'
                                 # (AF_PACKET capture of UDP/IPv4-framed
                                 # VDIF off the wire — the reference's
                                 # production transport, src/utils.c:
                                 # 345-407) or 'file:PATH' (replay)
    host: str = ""               # where this station's daemon runs:
                                 # ''/localhost = spawned by `launch`
                                 # locally; anything else = ssh fan-out
                                 # (the config/hosts first column,
                                 # scripts/launch:5-12)


@dataclass(frozen=True)
class ArrayConfig:
    """The whole array + mesh layout (replaces config/hosts, config/coadd,
    and the OpenMPI hostfiles of the reference coadd path)."""

    antennas: Tuple[AntennaConfig, ...] = tuple(
        AntennaConfig(station_id=i + 1, name=f"ea{i + 1:02d}")
        for i in range(8))
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)
    search: SearchConfig = field(default_factory=SearchConfig)
    trigger: TriggerConfig = field(default_factory=TriggerConfig)
    # mesh shape: antennas sharded over 'ant', search time blocks over 'time'
    mesh_ant: int = 1
    mesh_time: int = 1
    # service ports (the multicast group/port table role, multicast.h:10-26)
    command_port: int = 20001      # leader TCP command bus
    coincidencer_port: int = 27555  # candidate batches (trigger.py:37)
    trigger_port_base: int = 21000  # station k listens on base + station_id

    @property
    def nant(self) -> int:
        return len(self.antennas)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "ArrayConfig":
        """Load a cluster config from JSON (the config/hosts +
        config/coadd + hostfile role as one typed file)."""
        d = json.loads(text)
        d["antennas"] = tuple(AntennaConfig(**{**a, "position_m":
                                               tuple(a.get("position_m",
                                                           (0, 0, 0)))})
                              for a in d.get("antennas", []))
        for key, klass in (("pipeline", PipelineConfig),
                           ("search", SearchConfig),
                           ("trigger", TriggerConfig)):
            if key in d and isinstance(d[key], dict):
                sub = d[key]
                if key == "search" and "zap_ranges" in sub:
                    sub["zap_ranges"] = tuple(tuple(z)
                                              for z in sub["zap_ranges"])
                d[key] = klass(**sub)
        return cls(**d)

    @classmethod
    def load(cls, path: str) -> "ArrayConfig":
        with open(path) as fp:
            return cls.from_json(fp.read())

    def save(self, path: str) -> None:
        with open(path, "w") as fp:
            fp.write(self.to_json())

    @classmethod
    def tiny(cls, nant: int = 4, mesh_ant: int = 1, mesh_time: int = 1,
             **overrides) -> "ArrayConfig":
        return cls(
            antennas=tuple(AntennaConfig(station_id=i + 1, name=f"ea{i+1:02d}")
                           for i in range(nant)),
            pipeline=PipelineConfig.tiny(),
            search=SearchConfig.tiny(),
            mesh_ant=mesh_ant, mesh_time=mesh_time, **overrides)
