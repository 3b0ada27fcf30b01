"""Dedispersion benchmark on the card: seconds per production gulp for each
engine on the tolerance DM grid (4096 channels, 12 s gulps), and with
--sweep the kernel's launch parameters (time tile, warps, pipeline
stages).  Every timing ends in block_until_ready, after a warm-up call.

Usage:  python benchmarks/bench_search.py [--sweep] [--linear]
Prints one JSON line, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", action="store_true",
                    help="time the kernel over tile x warps x stages")
    ap.add_argument("--linear", action="store_true",
                    help="1024-trial linear grid instead of the tol grid")
    args = ap.parse_args(argv)

    import jax

    from chip_smoke import card_line, search_engine_for, time_call
    from vlite_fast import backend
    from vlite_fast.config import PipelineConfig, SearchConfig
    from vlite_fast.models import search as search_mod
    from vlite_fast.ops import dedisperse_pallas as ddp

    backend.enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench_search: needs a GPU, found {dev.platform!r}")
    cfg = PipelineConfig()
    scfg = SearchConfig(dm_grid_mode="linear") if args.linear \
        else SearchConfig()
    eng = search_engine_for(cfg, scfg)
    plan = eng.plan
    ntime_out = scfg.gulp_samps
    fb = jax.random.normal(jax.random.PRNGKey(0),
                           (ntime_out + plan.max_delay, cfg.nchanout))
    line = {"card": card_line(), "device_kind": dev.device_kind,
            "ndm": len(eng.dms), "gulp_samps": ntime_out, "engines": {}}
    for name in ("pallas", "subband", "fourier"):
        fn = jax.jit(lambda x, p, e=name: search_mod.dedisperse(
            e, x, p, ntime_out))
        line["engines"][name] = time_call(lambda: fn(fb, plan))
    if args.sweep:
        line["sweep"] = {}
        for tile, warps, stages in itertools.product(
                (512, 1024, 2048), (4, 8), (1, 3)):
            fn = jax.jit(lambda x, p, t=tile, w=warps, s=stages:
                         ddp.dedisperse_pallas(x, p, ntime_out, tile=t,
                                               num_warps=w, num_stages=s))
            line["sweep"][f"tile{tile}_w{warps}_s{stages}"] = time_call(
                lambda: fn(fb, plan))
    print(json.dumps(line))


if __name__ == "__main__":
    main()
