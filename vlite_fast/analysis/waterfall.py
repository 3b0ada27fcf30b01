"""Filterbank waterfall products (the make_plots/coarse_waterfall role,
ref src/make_plots.py:17-160, src/coarse_waterfall.py): downsample a
filterbank to a displayable time-frequency image and optionally render a
PNG per observation for the monitoring page."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from vlite_fast.utils import sigproc


def downsample(data: np.ndarray, max_time: int = 2048,
               max_chan: int = 512) -> np.ndarray:
    """Block-average (ntime, nchan) to at most (max_time, max_chan)."""
    nt, nc = data.shape
    ft = max(1, nt // max_time)
    fc = max(1, nc // max_chan)
    nt2, nc2 = nt - nt % ft, nc - nc % fc
    d = data[:nt2, :nc2].reshape(nt2 // ft, ft, nc2 // fc, fc)
    return d.mean(axis=(1, 3))


def waterfall_from_fil(path: str, max_time: int = 2048,
                       max_chan: int = 512) -> Tuple[np.ndarray, dict]:
    hdr, data = sigproc.read_filterbank(path)
    wf = downsample(data, max_time, max_chan)
    meta = {"tsamp": hdr.tsamp * (data.shape[0] // wf.shape[0]),
            "fch1": hdr.fch1,
            "foff": hdr.foff * (data.shape[1] // wf.shape[1]),
            "source": hdr.source_name}
    return wf, meta


def watch_and_render(fil_dir: str, out_dir: Optional[str] = None,
                     poll_s: float = 5.0, max_iterations: int = 0,
                     stop_flag=None) -> int:
    """Watch a directory for new .fil files and publish waterfall PNGs
    (the src/make_plots.py watch loop, ref make_plots.py:108-160).

    max_iterations=0 runs until stop_flag (a threading.Event) is set.
    Returns the number of PNGs rendered."""
    import os
    import time as _t
    out_dir = out_dir or fil_dir
    os.makedirs(out_dir, exist_ok=True)
    seen = set()
    rendered = 0
    it = 0
    while True:
        for f in sorted(os.listdir(fil_dir)):
            if not f.endswith(".fil") or f in seen:
                continue
            path = os.path.join(fil_dir, f)
            try:
                wf, meta = waterfall_from_fil(path)
                render_png(wf, meta,
                           os.path.join(out_dir,
                                        f.replace(".fil", ".png")))
                rendered += 1
            except Exception:
                pass   # partial/in-progress file; retry next poll
            else:
                seen.add(f)
        it += 1
        if max_iterations and it >= max_iterations:
            break
        if stop_flag is not None and stop_flag.is_set():
            break
        if max_iterations == 0 and stop_flag is None:
            break   # single pass when no loop control is given
        _t.sleep(poll_s)
    return rendered


def render_candidate_png(fb: np.ndarray, cand, tsamp: float,
                         freqs_mhz: np.ndarray, out_path: str) -> str:
    """Diagnostic plot for one candidate: the dispersed waterfall cutout,
    the matched-width smoothed version, and the dedispersed profile (the
    candidate plots make_plots publishes for triggers)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from vlite_fast.analysis import cutout as co

    start, blk = co.candidate_block(fb, cand, tsamp, freqs_mhz, wmult=3)
    sm = co.tophat(blk, cand.tfilt)
    prof = co.dedispersed_profile(blk, cand.dm, tsamp, freqs_mhz)
    fig, axes = plt.subplots(3, 1, figsize=(8, 9), dpi=100,
                             sharex=False)
    t0, t1 = start * tsamp, (start + blk.shape[0]) * tsamp
    for ax, data, title in ((axes[0], blk, "raw"),
                            (axes[1], sm, f"tophat 2^{cand.tfilt}")):
        lo, hi = np.percentile(data, [5, 95])
        ax.imshow(data.T, aspect="auto", origin="upper", vmin=lo, vmax=hi,
                  extent=[t0, t1, freqs_mhz.min(), freqs_mhz.max()])
        ax.set_ylabel(f"freq [MHz] ({title})")
    axes[2].plot(t0 + np.arange(len(prof)) * tsamp, prof)
    axes[2].set_xlabel("time [s]")
    axes[2].set_ylabel(f"DM {cand.dm:.1f} profile")
    fig.suptitle(f"S/N {cand.snr:.1f}  DM {cand.dm:.1f}  "
                 f"w {(cand.i1 - cand.i0) * tsamp * 1e3:.1f} ms")
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def render_png(wf: np.ndarray, meta: dict, out_path: str,
               vmin_pct: float = 5, vmax_pct: float = 95) -> str:
    """Render a waterfall PNG (matplotlib, headless)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    lo, hi = np.percentile(wf, [vmin_pct, vmax_pct])
    fig, ax = plt.subplots(figsize=(10, 6), dpi=100)
    extent = [0, wf.shape[0] * meta.get("tsamp", 1.0),
              meta.get("fch1", 0) + wf.shape[1] * meta.get("foff", -1),
              meta.get("fch1", 0)]
    ax.imshow(wf.T, aspect="auto", origin="upper", vmin=lo, vmax=hi,
              extent=extent, cmap="viridis")
    ax.set_xlabel("time [s]")
    ax.set_ylabel("frequency [MHz]")
    ax.set_title(meta.get("source", ""))
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return out_path
