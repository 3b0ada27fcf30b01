"""Host-side orchestration: the process zoo of the reference as one program.

The reference runs writer | process_baseband | heimdall | dumper as separate
POSIX processes glued by PSRDADA rings and multicast (SURVEY.md section 1).
Here one StationPipeline object runs the same stages for one antenna stream:

  capture/replay -> baseband ring (C++ shm, for triggered dumps)
                 -> DSP chain (jit, models/baseband_dsp)
                 -> .fil file + in-memory filterbank
                 -> gulp search (models/search) -> candidates

and an ArrayPipeline fans N stations into the coincidencer + triggered
dumper (the trigger.py + dumper roles).
"""

from __future__ import annotations

import os
import time
import dataclasses
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional

import numpy as np
import jax.numpy as jnp

from vlite_fast import constants as C
from vlite_fast.config import ArrayConfig, PipelineConfig, SearchConfig
from vlite_fast.models import baseband_dsp as dsp
from vlite_fast.models import search as search_mod
from vlite_fast.ops import dedisperse as dd
from vlite_fast.ops import quantize as q_ops
from vlite_fast.runtime import trigger as trig
from vlite_fast.runtime.control import ObservationDocument
from vlite_fast.runtime.dumper import TriggeredDumper
from vlite_fast.runtime.ring import RingBuffer, FLAG_OBS_START
from vlite_fast.utils import sigproc
from vlite_fast.utils.log import Metrics, RTMonitor, make_logger


class GulpStream:
    """Bounded streaming block accumulator for gulp searches.

    Holds consecutive (nsamp, ...) blocks with absolute sample offsets;
    consumers fetch [start, stop) windows and prune consumed blocks so
    memory stays O(gulp), not O(observation) — the fix for round-1's
    O(T^2) drain (ADVICE.md)."""

    def __init__(self):
        self.blocks: List[np.ndarray] = []
        self.start = 0          # absolute sample index of blocks[0][0]

    @property
    def total(self) -> int:
        return self.start + sum(b.shape[0] for b in self.blocks)

    def append(self, block: np.ndarray) -> None:
        self.blocks.append(block)

    def window(self, start: int, stop: int) -> np.ndarray:
        parts = []
        off = self.start
        for blk in self.blocks:
            lo, hi = max(start - off, 0), min(stop - off, blk.shape[0])
            if lo < hi:
                parts.append(blk[lo:hi])
            off += blk.shape[0]
            if off >= stop:
                break
        return np.concatenate(parts, axis=0) if len(parts) != 1 else parts[0]

    def prune(self, keep_from: int) -> None:
        while self.blocks and (
                self.start + self.blocks[0].shape[0] <= keep_from):
            self.start += self.blocks[0].shape[0]
            self.blocks.pop(0)


class DeviceGulpStream:
    """Device-side mirror of GulpStream.

    The jitted chain PRODUCES the quantized filterbank on the accelerator;
    keeping those block handles alive lets the gulp search read them in
    place (SinglePulseSearch.search_gulp_device) instead of re-uploading
    ~38 MB of packed bytes per production gulp.  Windows are only served
    when they start exactly on a stored block boundary — true for every
    steady-state gulp when gulp_samps is a multiple of the per-second
    output length — so sliced shapes stay static and the search compiles
    once.  Misaligned requests return None and the caller falls back to
    the host-byte path (ragged flush tails, tiny test geometries).
    """

    def __init__(self):
        self.blocks: List = []
        self.start = 0          # absolute sample index of blocks[0][0]

    @property
    def total(self) -> int:
        return self.start + sum(int(b.shape[0]) for b in self.blocks)

    def append(self, block) -> None:
        self.blocks.append(block)

    def window(self, start: int, stop: int, pad_to: int = 0,
               fill: int = 0):
        """Serve [start, stop) as one device array, or None if the data
        isn't fully device-resident / boundary-aligned.

        pad_to > stop-start appends device-side fill bytes up to pad_to
        rows (the quantizer's near-zero level), so ragged flush tails
        reuse the steady-state compiled search instead of bouncing ~38 MB
        of packed bytes through the host (ref: heimdall searches its
        final partial gulp in place too)."""
        off = self.start
        if start < off:
            return None
        i = 0
        while (i < len(self.blocks)
               and off + int(self.blocks[i].shape[0]) <= start):
            off += int(self.blocks[i].shape[0])
            i += 1
        if off != start:        # not boundary-aligned: host path instead
            return None
        parts, have = [], 0
        j = i
        while j < len(self.blocks) and have < stop - start:
            parts.append(self.blocks[j])
            have += int(self.blocks[j].shape[0])
            j += 1
        if have < stop - start:
            return None
        cat = parts[0] if len(parts) == 1 else jnp.concatenate(parts,
                                                               axis=0)
        cat = cat[:stop - start]
        if pad_to > stop - start:
            cat = jnp.concatenate(
                [cat, jnp.full((pad_to - (stop - start),
                                int(cat.shape[1])), fill, jnp.uint8)],
                axis=0)
        return cat

    def host_window(self, start: int, stop: int) -> np.ndarray:
        """Fetch [start, stop) to host (flush tails, misaligned fallback —
        rare paths; steady-state gulps never leave the device)."""
        parts = []
        off = self.start
        for blk in self.blocks:
            n = int(blk.shape[0])
            lo, hi = max(start - off, 0), min(stop - off, n)
            if lo < hi:
                parts.append(np.asarray(blk)[lo:hi])
            off += n
            if off >= stop:
                break
        return (np.concatenate(parts, axis=0) if len(parts) != 1
                else parts[0])

    def prune(self, keep_from: int) -> None:
        while self.blocks and (
                self.start + int(self.blocks[0].shape[0]) <= keep_from):
            self.start += int(self.blocks[0].shape[0])
            self.blocks.pop(0)


@dataclass
class ObservationProducts:
    fil_path: Optional[str]
    candidates: List[dd.Candidate]
    seconds: int
    rt_factor: float
    dropped: int = 0
    start_unix: float = 0.0   # unix time of the first processed second


class StationPipeline:
    """One antenna stream end-to-end on this host."""

    def __init__(self, station_id: int, cfg: PipelineConfig,
                 scfg: SearchConfig, out_dir: str = "/tmp/vfast",
                 ring_seconds: int = 40, keep_ring: bool = True,
                 write_cands: bool = True, write_kurto: bool = False):
        # ring_seconds MUST exceed the gulp-bound candidate latency
        # (<=36.4 s at the 24 s production gulp) or triggered voltage
        # dumps always miss the event: the reference runs 32-60 deep
        # (scripts/start_writer:12).  40 s of production baseband = 10 GB
        # of shm per antenna, same class as the reference's ring.
        self.station_id = station_id
        self.cfg = cfg
        self.scfg = scfg
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.log = make_logger(f"station{station_id:02d}")
        self.metrics = Metrics()
        sec_bytes = cfg.npol_in * cfg.sample_rate
        self.ring: Optional[RingBuffer] = None
        if keep_ring:
            self.ring = RingBuffer(f"/vfast_bb_{station_id:02d}",
                                   bufsz=sec_bytes, nbufs=ring_seconds,
                                   create=True)
        freqs = cfg.freqs_mhz()
        self.search = search_mod.SinglePulseSearch(
            scfg, cfg.tsamp, freqs,
            nsub=min(128, cfg.nchanout), nbatch=min(scfg.ndm, 128))
        self.write_cands = write_cands
        self.write_kurto = write_kurto   # WRITE_KURTO role (weights dump)
        self._weights_accum: List[np.ndarray] = []
        self.state = dsp.init_state(cfg)
        # injection-free twin of the chain for seconds outside the ~2 s
        # post-arm window (host-side gating; see feed_second)
        self._cfg_noinject = dataclasses.replace(cfg, inject_frb=False) \
            if cfg.inject_frb else cfg
        self._inject_until = -1
        self._prewarmed = False
        self._fb = GulpStream()
        self._fb_dev = DeviceGulpStream()
        self._searched_to = 0
        self._pending = None   # device handle of the last second's output
        self._out_samps_per_sec = cfg.seg_per_sec * cfg.out_samps_per_seg
        # taps: callables (station_id, abs_offset, packed_block) invoked on
        # every drained block (the coadd-ring writer role,
        # ref process_baseband.cu:1416-1422)
        self.block_taps: List = []

    def _fil_header(self, od: ObservationDocument,
                    tstart_unix: float) -> sigproc.FilterbankHeader:
        cfg = self.cfg
        return sigproc.FilterbankHeader(
            source_name=od.name or "unknown",
            telescope_id=self.station_id,
            src_raj=sigproc.radians_to_sigproc(od.ra, True),
            src_dej=sigproc.radians_to_sigproc(od.dec, False),
            fch1=cfg.fch1_mhz, foff=cfg.chan_bw_mhz, nchans=cfg.nchanout,
            nbits=cfg.nbit, tstart=tstart_unix / 86400.0 + 40587.0,
            tsamp=cfg.tsamp, nifs=cfg.npol_out)

    def run_observation(self, seconds: Iterable, od: ObservationDocument,
                        write_fil: bool = True,
                        search_live: bool = True,
                        profile_dir: Optional[str] = None
                        ) -> ObservationProducts:
        """seconds: iterable of (unix_second, samples[npol, rate] uint8).

        profile_dir enables a jax profiler trace of the observation (the
        PROFILE build-flag role, ref process_baseband.h:9-13; open with
        tensorboard/xprof)."""
        if profile_dir:
            import jax
            with jax.profiler.trace(profile_dir):
                return self.run_observation(seconds, od, write_fil,
                                            search_live, None)
        self.begin_observation(od, write_fil=write_fil,
                               search_live=search_live)
        for sec, buf in seconds:
            self.feed_second(sec, buf)
        return self.end_observation()

    # --- streaming interface (one observation = begin / feed* / end) -----
    def begin_observation(self, od: ObservationDocument,
                          write_fil: bool = True,
                          search_live: bool = True) -> None:
        self.state = dsp.init_state(self.cfg)  # EMA reseeds per obs
        self._fb, self._searched_to = GulpStream(), 0
        self._fb_dev = DeviceGulpStream()
        self._taps_offset = 0
        self._pending = None
        self._weights_accum = []
        self._histo_accum = None
        self._od = od
        self._write_fil = write_fil
        self._search_live = search_live
        self._rt = RTMonitor()
        self._fil = None
        self._fil_plain = None
        self._fil_path = None
        self._cands: List[dd.Candidate] = []
        self._nsec = 0
        self._t0_unix = None
        self._inject_until = -1
        self._prewarm()
        if self.ring is not None:
            self.ring.set_obs_header(od.to_ascii_header(self.station_id))

    def _prewarm(self) -> None:
        """Compile BOTH chain programs (injection-armed + injection-free
        twin) before the first second is fed.  The twin is first
        dispatched mid-observation (feed_second's host gating), and a
        lazy compile there is a multi-minute real-time stall on a cold
        cache — a real-time-system bug, not a throughput detail.  One
        dummy dispatch per program populates the jit cache; subsequent
        dispatches reuse it (process_second is jitted with cfg static)."""
        if self._prewarmed or not self.cfg.inject_frb:
            return
        import jax
        dummy = jnp.zeros((self.cfg.npol_in, self.cfg.sample_rate),
                          jnp.uint8)
        st = dsp.init_state(self.cfg)
        for prog_cfg in (self.cfg, self._cfg_noinject):
            out, _ = dsp.process_second(prog_cfg, dummy, st,
                                        jnp.bool_(False))
            jax.block_until_ready(out)
        self._prewarmed = True

    def feed_second(self, sec: float, buf: np.ndarray) -> List[dd.Candidate]:
        """Dispatch one second; returns candidates that became final while
        this second computes (from the previous drain)."""
        cfg = self.cfg
        if self._t0_unix is None:
            self._t0_unix = float(sec)
            if self._write_fil:
                stamp = time.strftime("%Y%m%d_%H%M%S",
                                      time.gmtime(self._t0_unix))
                self._fil_path = os.path.join(
                    self.out_dir, f"{stamp}_ea{self.station_id:02d}.fil")
                self._fil = sigproc.FilterbankWriter(
                    self._fil_path, self._fil_header(self._od,
                                                     self._t0_unix))
                if cfg.rfi_mode == 2:
                    # mode 2 produces BOTH streams (ref -r 2 writes the
                    # plain and excised filterbanks); the excised stream
                    # is the searched primary, the plain one a product
                    self._fil_plain = sigproc.FilterbankWriter(
                        self._fil_path.replace(".fil", "_plain.fil"),
                        self._fil_header(self._od, self._t0_unix))
        if self.ring is not None:
            self.ring.write(buf.reshape(-1), timestamp=float(sec),
                            flags=FLAG_OBS_START if self._nsec == 0 else 0,
                            overwrite=True)
        arm_host = bool(cfg.inject_frb
                        and self._nsec % C.INJECT_PERIOD_S == 0)
        if arm_host:
            self._inject_until = self._nsec + dsp.inject_window_seconds(cfg)
        # host-side injection gating: outside the ~2 s window after
        # arming, the injected track cannot intersect this second, so
        # dispatch the injection-free compiled chain instead (byte-exact
        # — the skipped path multiplies by all-ones; see
        # dsp.inject_window_seconds).  The carried segs_since_inject
        # bookkeeping is identical in both programs.
        use_cfg = cfg if (cfg.inject_frb
                          and self._nsec < self._inject_until) \
            else self._cfg_noinject
        out, self.state = dsp.process_second(
            use_cfg, jnp.asarray(buf), self.state, jnp.asarray(arm_host))
        # double-buffered output drain (the reference's 10 s host-side
        # output buffering, process_baseband.cu:691-697): the previous
        # second's device result is fetched and post-processed while this
        # second's dispatch computes asynchronously
        pending_new = out.packed_kur if cfg.rfi_mode else out.packed
        plain_new = (out.packed if (cfg.rfi_mode == 2
                                    and self._fil_plain is not None)
                     else None)
        if self._fil is not None or self.block_taps:
            try:
                # start the D2H copy now so it overlaps the next second's
                # device compute; _drain's np.asarray then finds it done
                pending_new.copy_to_host_async()
                if plain_new is not None:
                    plain_new.copy_to_host_async()
            except AttributeError:
                pass
        if self.write_kurto:
            self._weights_accum.append(np.asarray(out.weights))
        if cfg.do_histo and out.histo is not None and out.histo.size:
            h = np.asarray(out.histo)
            self._histo_accum = h if self._histo_accum is None \
                else self._histo_accum + h
        before = len(self._cands)
        if self._pending is not None:
            self._drain(*self._pending)
        self._pending = (pending_new, plain_new)
        self._nsec += 1
        deficit = self._rt.add(1.0)
        if deficit is not None:
            self.log.warning("falling behind real time by %.2f s", deficit)
        return self._cands[before:]

    def end_observation(self) -> ObservationProducts:
        if self._pending is not None:
            self._drain(*self._pending)
            self._pending = None
        if self._search_live:
            self._cands.extend(self._search_ready(flush=True))
        if self._fil is not None:
            self._fil.close()
        if self._fil_plain is not None:
            self._fil_plain.close()
        cands, fil_path = self._cands, self._fil_path
        self.metrics.set("vfast_rt_factor", self._rt.realtime_factor)
        self.metrics.set("vfast_candidates", len(cands))
        if fil_path and self.write_cands and cands:
            # heimdall-style candidate file alongside the filterbank
            with open(fil_path.replace(".fil", ".cand"), "w") as fp:
                for c in cands:
                    fp.write(c.to_line() + "\n")
        if fil_path and self._histo_accum is not None:
            # DOHISTO per-obs product (ref pb_kernels.cu:321-336)
            np.savez_compressed(fil_path.replace(".fil", "_histo.npz"),
                                histogram=self._histo_accum)
        if fil_path and self.write_kurto and self._weights_accum:
            np.savez_compressed(fil_path.replace(".fil", "_kurto.npz"),
                                weights=np.concatenate(
                                    self._weights_accum, axis=-1))
        return ObservationProducts(
            fil_path=fil_path, candidates=cands, seconds=self._nsec,
            rt_factor=self._rt.realtime_factor,
            dropped=self.ring.dropped if self.ring else 0,
            start_unix=self._t0_unix or 0.0)

    def _drain(self, packed_dev, plain_dev=None) -> None:
        if self._search_live:
            # device handle: in-place search.  Only retained when the
            # search consumes (and prunes) it — search_live=False would
            # otherwise pin every second's output on the device,
            # O(observation) HBM (the round-1 unbounded-drain class).
            self._fb_dev.append(packed_dev)
        if self._fil is not None or self.block_taps:
            # host bytes are only pulled when a host consumer exists
            # (.fil writer / coadd taps); the search reads the device
            # copy in place
            packed = np.asarray(packed_dev)
            if self._fil is not None:
                self._fil.write_block(packed)
            if plain_dev is not None and self._fil_plain is not None:
                self._fil_plain.write_block(np.asarray(plain_dev))
            if self._search_live:
                self._fb.append(packed)
            for tap in self.block_taps:
                tap(self.station_id, self._taps_offset, packed)
            self._taps_offset += packed.shape[0]
        if self._search_live:
            self._cands.extend(self._search_ready())

    def _search_ready(self, flush: bool = False) -> List[dd.Candidate]:
        """Search any complete gulps accumulated since the last call.

        Only the new gulp window is unpacked (the packed accumulator is
        pruned as gulps complete) — per-gulp cost is O(gulp), not
        O(observation so far)."""
        gulp = self.scfg.gulp_samps
        overlap = self.search.overlap
        total = max(self._fb.total, self._fb_dev.total)
        out: List[dd.Candidate] = []
        while total - self._searched_to >= gulp + overlap or (
                flush and total - self._searched_to > overlap + 64):
            stop = min(self._searched_to + gulp + overlap, total)
            nrows = stop - self._searched_to
            # flush tails pad to the steady-state shape ON DEVICE (same
            # compiled program, zero host round trip for the bytes)
            fill = q_ops.NEAR_ZERO_FILL[self.cfg.nbit]
            dev_win = self._fb_dev.window(self._searched_to, stop,
                                          pad_to=gulp + overlap,
                                          fill=fill)
            if dev_win is not None:
                # filterbank bytes never left the device: search in place
                # nrows <= gulp + overlap always, so this covers both the
                # steady (== gulp) and padded-flush (< gulp) cases
                found = self.search.search_gulp_device(
                    dev_win, self.cfg.nbit, t_offset=self._searched_to,
                    nvalid=nrows - overlap)
            else:
                # flush tails / misaligned windows: host path (bytes go
                # to the device as-is; dequantize in-graph)
                packed = (self._fb.window(self._searched_to, stop)
                          if self._fb.total >= stop
                          else self._fb_dev.host_window(
                              self._searched_to, stop))
                found = self.search.search_gulp_packed(
                    packed, self.cfg.nbit, t_offset=self._searched_to)
            out.extend(found)
            # top-k saturation accounting (RFI-storm guard): count gulps
            # where a DM band's quota overflowed and crossings were
            # dropped on device — the operator signal to feed zap_ranges
            st = self.search.last_gulp_stats
            self.metrics.set("vfast_gulp_crossings", st["n_crossings"])
            if st["saturated_bands"]:
                self.metrics.inc("vfast_topk_saturated_total",
                                 st["saturated_bands"])
            if found:
                # gulp-bound candidate latency in data time (the
                # reference documents 40-50 s, trigger.py:164-166)
                lat = max((stop * self.cfg.tsamp) - c.peak_time
                          for c in found)
                self.metrics.set("vfast_cand_latency_data_s",
                                 round(lat, 2))
            self._searched_to += min(gulp, nrows - overlap)
            self._fb.prune(self._searched_to)
            self._fb_dev.prune(self._searched_to)
            if flush and total - self._searched_to <= overlap + 64:
                break
        return out

    def close(self):
        if self.ring is not None:
            self.ring.close(unlink=True)


COADD_BEAM = -1   # pseudo-beam id of the coadded stream


class CoaddSearcher:
    """Search the coadded filterbank stream in the host runtime.

    The reference's sqrt(N) sensitivity path: every antenna's
    process_baseband also writes a coadd ring, agdadacoadd MPI-reduces
    them, and agtriggerhook searches the sum (ref scripts/start_coadd:19-57,
    scripts/start_process:21).  Here the per-station DSP taps feed packed
    blocks; once every station has delivered a sample range, the dequantized
    sum (1/sqrt(N) scaled, models/coadd.coadd) enters a gulp search
    identical to the per-beam one.  Candidates carry beam COADD_BEAM.
    """

    def __init__(self, station_ids: List[int], cfg: PipelineConfig,
                 scfg: SearchConfig, nsub: int = 0, nbatch: int = 0):
        self.cfg, self.scfg = cfg, scfg
        self._all_station_ids = list(station_ids)
        self.station_ids = list(station_ids)
        freqs = cfg.freqs_mhz()
        self.search = search_mod.SinglePulseSearch(
            scfg, cfg.tsamp, freqs,
            nsub=nsub or min(128, cfg.nchanout),
            nbatch=nbatch or min(scfg.ndm, 128))
        self._pending: Dict[int, List[np.ndarray]] = {
            sid: [] for sid in self.station_ids}
        self._next_offset: Dict[int, int] = {
            sid: 0 for sid in self.station_ids}
        self._co = GulpStream()
        self._searched_to = 0
        self.cands: List[dd.Candidate] = []
        self.log = make_logger("coadd")

    def reset(self) -> None:
        self.station_ids = list(self._all_station_ids)  # un-retire
        self._pending = {sid: [] for sid in self.station_ids}
        self._next_offset = {sid: 0 for sid in self.station_ids}
        self._co, self._searched_to = GulpStream(), 0
        self.cands = []

    def tap(self, station_id: int, offset: int, packed: np.ndarray) -> None:
        """StationPipeline block tap: collect, and coadd whatever sample
        range every station has now delivered.  Blocks from retired
        stations (their stream ended; their pipeline drains a final
        pending second afterwards) are dropped.

        Lockstep is VERIFIED, not assumed: each station's `offset` must
        continue where its last block ended.  A gap (a station dropped a
        block — exception in its drain path, late join) is zero-filled in
        filterbank space so every later coadd still sums aligned time
        ranges; a rewind/duplicate keeps first-arrival samples only."""
        if station_id not in self._pending:
            return
        exp = self._next_offset[station_id]
        end = offset + packed.shape[0]
        if offset > exp:
            self.log.warning(
                "coadd: station %d jumped %d->%d; zero-filling %d samples "
                "to keep the coadd time-aligned", station_id, exp, offset,
                offset - exp)
            self._pending[station_id].append(("pad", offset - exp))
        elif offset < exp:
            overlap = exp - offset
            if overlap >= packed.shape[0]:
                self.log.warning(
                    "coadd: station %d re-delivered [%d,%d) already "
                    "consumed; dropped", station_id, offset,
                    offset + packed.shape[0])
                return
            self.log.warning(
                "coadd: station %d overlapped %d samples; keeping the "
                "first-arrival range", station_id, overlap)
            packed = packed[overlap:]
        self._pending[station_id].append(packed)
        self._next_offset[station_id] = end
        self._advance()

    def retire(self, station_id: int) -> None:
        """A station's stream ended (or died): drop it from the lockstep
        set so the coadd keeps covering new data with the remaining N
        (otherwise every other station's blocks pile up unbounded and the
        coadded search silently stops).  The per-gulp robust noise
        estimate absorbs the sqrt(N) scale change."""
        if station_id in self.station_ids:
            self.station_ids.remove(station_id)
            self._pending.pop(station_id, None)
            self.log.info("coadd: station %d retired (%d remain)",
                          station_id, len(self.station_ids))
            if self.station_ids:
                self._advance()

    @staticmethod
    def _blk_len(b) -> int:
        return b[1] if isinstance(b, tuple) else b.shape[0]

    @staticmethod
    def _blk_split(b, n: int):
        """(first n samples, remainder or None) of a packed/pad entry."""
        if isinstance(b, tuple):
            rest = b[1] - n
            return ("pad", n), (("pad", rest) if rest > 0 else None)
        return b[:n], (b[n:] if b.shape[0] > n else None)

    def _blk_fb(self, b) -> np.ndarray:
        """Dequantize a packed entry; a pad is zero filterbank (the
        gap-fill convention — zero contributes nothing to the sum)."""
        if isinstance(b, tuple):
            return np.zeros((b[1], self.cfg.nchanout), np.float32)
        return search_mod.filterbank_from_packed(
            b, self.cfg.nbit, self.cfg.nchanout)

    def _advance(self) -> None:
        while self.station_ids and all(
                self._pending[sid] for sid in self.station_ids):
            blocks = [self._pending[sid].pop(0) for sid in self.station_ids]
            n = min(self._blk_len(b) for b in blocks)
            if any(self._blk_len(b) != n for b in blocks):
                # ragged blocks (different tap granularities): consume the
                # common prefix and REQUEUE the remainders so streams stay
                # sample-aligned (trimming would desynchronize the time
                # axis of every later coadd)
                self.log.warning("ragged coadd blocks: %s",
                                 [self._blk_len(b) for b in blocks])
                head = []
                for sid, b in zip(self.station_ids, blocks):
                    first, rest = self._blk_split(b, n)
                    if rest is not None:
                        self._pending[sid].insert(0, rest)
                    head.append(first)
                blocks = head
            fbs = np.stack([self._blk_fb(b) for b in blocks])
            co = fbs.sum(axis=0) * np.float32(1.0 / np.sqrt(len(fbs)))
            # float16 storage halves the rolling-window footprint; values
            # are O(10) sums of quantization levels — no precision concern
            self._co.append(co.astype(np.float16))
            self.cands.extend(self._search_ready())

    def _search_ready(self, flush: bool = False) -> List[dd.Candidate]:
        gulp = self.scfg.gulp_samps
        overlap = self.search.overlap
        total = self._co.total
        out: List[dd.Candidate] = []
        while total - self._searched_to >= gulp + overlap or (
                flush and total - self._searched_to > overlap + 64):
            stop = min(self._searched_to + gulp + overlap, total)
            # float16 ships as-is; the device program casts in-graph
            # (half the host->device bytes of a f32 conversion here)
            block = self._co.window(self._searched_to, stop)
            out.extend(self.search.search_gulp(
                block, t_offset=self._searched_to))
            self._searched_to += min(gulp, block.shape[0] - overlap)
            self._co.prune(self._searched_to)
            if flush and total - self._searched_to <= overlap + 64:
                break
        return out

    def finish(self) -> List[dd.Candidate]:
        self.cands.extend(self._search_ready(flush=True))
        return self.cands


class ArrayPipeline:
    """N stations + coincidencer + triggered dumps (the cluster roles of
    messenger/trigger.py/dumper on one host or one host's share)."""

    def __init__(self, acfg: ArrayConfig, out_dir: str = "/tmp/vfast",
                 keep_rings: bool = True, search_coadd: bool = True):
        self.acfg = acfg
        self.out_dir = out_dir
        self.stations = [
            StationPipeline(a.station_id, acfg.pipeline, acfg.search,
                            out_dir=out_dir, keep_ring=keep_rings)
            for a in acfg.antennas]
        self.tcfg = acfg.trigger
        self.log = make_logger("array")
        self.coadd: Optional[CoaddSearcher] = None
        if search_coadd and len(self.stations) >= 2:
            self.coadd = CoaddSearcher(
                [st.station_id for st in self.stations],
                acfg.pipeline, acfg.search)
            for st in self.stations:
                st.block_taps.append(self.coadd.tap)

    def run_streaming(self, per_ant_seconds: Dict[int, Iterable],
                      od: ObservationDocument,
                      coincide_every_s: int = 8) -> dict:
        """Interleaved real-time serving: every data-second is dispatched
        for ALL stations before any result is drained (async device
        dispatch overlaps the antennas on one card), and coincidence +
        triggering run every `coincide_every_s` seconds instead of at observation end
        (latency: gulp-bound like the reference's 40-50 s, not
        observation-bound)."""
        iters = {st.station_id: iter(per_ant_seconds[st.station_id])
                 for st in self.stations}
        if self.coadd is not None:
            self.coadd.reset()
        for st in self.stations:
            st.begin_observation(od)
        dumpers = {st.station_id: TriggeredDumper(
            st.ring, os.path.join(self.out_dir, "dumps"),
            station_id=st.station_id, max_dump_s=self.tcfg.max_dump_s)
            for st in self.stations if st.ring is not None}
        triggers: List[trig.Trigger] = []
        dumps = []
        sent = set()
        nsec = 0
        live = dict(iters)
        while live:
            for st in self.stations:
                if st.station_id not in live:
                    continue
                try:
                    sec, buf = next(live[st.station_id])
                except StopIteration:
                    del live[st.station_id]
                    if self.coadd is not None:
                        self.coadd.retire(st.station_id)
                    continue
                st.feed_second(sec, buf)
            nsec += 1
            if nsec % coincide_every_s == 0:
                self._coincide_and_dump(od, triggers, dumps, dumpers, sent)
        products = {st.station_id: st.end_observation()
                    for st in self.stations}
        if self.coadd is not None:
            self.coadd.finish()
        self._coincide_and_dump(od, triggers, dumps, dumpers, sent)
        return {"products": products, "triggers": triggers, "dumps": dumps,
                "coadd_candidates": list(self.coadd.cands)
                if self.coadd else []}

    def _coincide_and_dump(self, od, triggers, dumps, dumpers, sent):
        utc0 = min((st._t0_unix or od.start_time for st in self.stations),
                   default=od.start_time)
        per_beam = {st.station_id: list(st._cands) for st in self.stations}
        if self.coadd is not None:
            per_beam[COADD_BEAM] = list(self.coadd.cands)
        coincided = trig.coincidence(per_beam, self.acfg.pipeline.tsamp,
                                     delta_dm=self.tcfg.delta_dm,
                                     delta_w=self.tcfg.delta_w)
        for t in trig.make_triggers(coincided, utc0, self.tcfg,
                                    coadd_beam=COADD_BEAM):
            key = (round(t.t0, 3), round(t.dm, 2))
            if key in sent:
                continue
            sent.add(key)
            triggers.append(t)
            for d in dumpers.values():
                rec = d.dump(t)
                if rec:
                    dumps.append(rec)

    def run_observation(self, per_ant_seconds: Dict[int, Iterable],
                        od: ObservationDocument) -> dict:
        if self.coadd is not None:
            self.coadd.reset()
        products = {}
        for st in self.stations:
            products[st.station_id] = st.run_observation(
                per_ant_seconds[st.station_id], od)
        per_beam = {sid: p.candidates for sid, p in products.items()}
        if self.coadd is not None:
            per_beam[COADD_BEAM] = self.coadd.finish()
        coincided = trig.coincidence(per_beam, self.acfg.pipeline.tsamp,
                                     delta_dm=self.tcfg.delta_dm,
                                     delta_w=self.tcfg.delta_w)
        # dump windows are referenced to the observation start time
        triggers = trig.make_triggers(coincided, od.start_time, self.tcfg,
                                      coadd_beam=COADD_BEAM)
        dumps = []
        for st in self.stations:
            if st.ring is None:
                continue
            dmp = TriggeredDumper(st.ring, os.path.join(self.out_dir,
                                                        "dumps"),
                                  station_id=st.station_id,
                                  max_dump_s=self.tcfg.max_dump_s)
            for t in triggers:
                rec = dmp.dump(t)
                if rec:
                    dumps.append(rec)
        return {"products": products, "triggers": triggers, "dumps": dumps,
                "coadd_candidates": list(self.coadd.cands)
                if self.coadd else []}

    def close(self):
        for st in self.stations:
            st.close()
