"""The one place that maps a JAX platform to what runs on it, plus the
process-level settings every entry point shares (compile cache, how
local stations share the cards).

Nothing here picks an implementation silently: an unknown platform is
an error, and interpret mode for Pallas kernels is only ever requested
explicitly by a test.
"""

from __future__ import annotations

import math
import os
import subprocess
from typing import Dict, List, Optional, Tuple

# Dedispersion engine per platform.  The GPU entry is the per-gulp winner
# on the card at the production tolerance grid (PERF.md lists all three
# engines' times); the CPU keeps the XLA gather engine, which needs no
# kernel compiler.
DEDISP_ENGINES: Dict[str, str] = {"cpu": "subband", "gpu": "pallas"}

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def dedisp_engine(platform: Optional[str] = None) -> str:
    """Dedispersion engine for `platform` (default: JAX's backend)."""
    if platform is None:
        import jax
        platform = jax.default_backend()
    try:
        return DEDISP_ENGINES[platform]
    except KeyError:
        raise ValueError(f"no dedispersion engine for platform "
                         f"{platform!r} (known: {sorted(DEDISP_ENGINES)})"
                         ) from None


def compile_cache_dir(environ=None) -> Optional[str]:
    """The compile-cache directory to set in code: None when
    JAX_COMPILATION_CACHE_DIR is set (JAX reads it itself), otherwise
    <repo>/.jax_cache (gitignored).  The path is part of the cache key,
    so it stays fixed."""
    environ = os.environ if environ is None else environ
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache; returns its directory."""
    import jax
    path = compile_cache_dir()
    if path is None:
        return os.environ["JAX_COMPILATION_CACHE_DIR"]
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def count_gpus() -> int:
    """Cards on this host, from nvidia-smi (0 when there is none).  Stays
    off JAX: a launcher that initialised JAX would reserve a card."""
    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return 0
    if out.returncode:
        return 0
    return sum(1 for ln in out.stdout.splitlines()
               if ln.startswith("GPU "))


def station_placement(n_stations: int, n_gpus: int,
                      mem_budget: float = 0.9
                      ) -> Tuple[str, List[Dict[str, str]]]:
    """Environment for each of `n_stations` local station processes.

    A JAX process reserves most of a card's memory when it starts, so a
    second process on the same card fails for want of memory.  With at
    least as many cards as stations each station is pinned to its own
    card ('pinned'); otherwise stations are dealt round-robin over the
    cards and each gets an explicit XLA_PYTHON_CLIENT_MEM_FRACTION share
    of its card ('shared').  No card: no settings ('none')."""
    if n_gpus <= 0:
        return "none", [{} for _ in range(n_stations)]
    if n_gpus >= n_stations:
        return "pinned", [{"CUDA_VISIBLE_DEVICES": str(i)}
                          for i in range(n_stations)]
    per_card = [0] * n_gpus
    for i in range(n_stations):
        per_card[i % n_gpus] += 1
    envs = []
    for i in range(n_stations):
        card = i % n_gpus
        share = math.floor(100 * mem_budget / per_card[card]) / 100
        envs.append({"CUDA_VISIBLE_DEVICES": str(card),
                     "XLA_PYTHON_CLIENT_MEM_FRACTION": f"{share:.2f}"})
    return "shared", envs
