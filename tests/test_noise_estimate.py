"""Quantify the strided-subsampled noise median at PRODUCTION geometry
(VERDICT r2 weak #6): boxcar_snr's per-trial robust sigma is estimated
from ~10240 strided samples instead of a full 30720-sample sort.  These
tests bound the S/N error that approximation
introduces against the exact sort at the real gulp shape.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from vlite_fast.ops import dedisperse as dd

NDM = 1024          # production linear grid
NTIME = 30720       # production gulp (24 s at 781.25 us)
WIDTHS = (1, 2, 4, 8, 16, 32, 64)
NCHAN_EFF = 3710.0  # 4096 minus zap ranges


@pytest.fixture(scope="module")
def cubes():
    """Exact vs subsampled S/N cubes on the same production-shaped
    DM-time plane: unit-ish noise plus a dispersed-pulse stand-in and a
    bright RFI row (outliers must not bias the robust estimate)."""
    rng = np.random.default_rng(11)
    dmt = rng.standard_normal((NDM, NTIME)).astype(np.float32) * 61.0
    dmt[312, 15000:15004] += 2500.0          # a pulse-like excursion
    dmt[0, ::97] += 900.0                    # zero-DM RFI comb
    dmt = jnp.asarray(dmt)
    exact = np.asarray(dd.boxcar_snr(dmt, NCHAN_EFF, WIDTHS,
                                     noise_subsample=0))
    sub = np.asarray(dd.boxcar_snr(dmt, NCHAN_EFF, WIDTHS,
                                   noise_subsample=8192))
    return exact, sub


def test_sigma_error_bounded(cubes):
    """Per-trial sigma relative error of the default stride-3 estimate:
    measured ~1.0% RMS with a ~2.8% worst trial over 1024; bound both
    with margin."""
    exact, sub = cubes
    # S/N ratio per trial == sigma_exact / sigma_sub (same numerator)
    with np.errstate(invalid="ignore", divide="ignore"):
        ratio = np.where(exact[0] != 0, sub[0] / exact[0], 1.0)
    rel = np.abs(np.nanmedian(ratio, axis=1) - 1.0)   # (NDM,)
    assert rel.max() < 0.04, rel.max()
    assert np.sqrt((rel ** 2).mean()) < 0.015, np.sqrt((rel ** 2).mean())


def test_snr_error_at_crossings_bounded(cubes):
    """Where it matters — samples above the 6-sigma threshold — the
    subsampled S/N differs from exact by well under the trigger margin
    (threshold 6.0 vs trigger cut 7.5, src/trigger.py:45)."""
    exact, sub = cubes
    mask = exact > 6.0
    assert mask.any()
    err = np.abs(sub[mask] - exact[mask]) / exact[mask]
    assert err.max() < 0.04, err.max()
    assert np.median(err) < 0.015, np.median(err)


def test_exact_at_test_geometries():
    """ntime <= noise_subsample: the stride is 1 and the estimate is the
    exact median (every CPU-mesh test geometry takes this path)."""
    rng = np.random.default_rng(0)
    dmt = jnp.asarray(rng.standard_normal((16, 1500)).astype(np.float32))
    a = np.asarray(dd.boxcar_snr(dmt, 64.0, (1, 2), noise_subsample=8192))
    b = np.asarray(dd.boxcar_snr(dmt, 64.0, (1, 2), noise_subsample=0))
    np.testing.assert_array_equal(a, b)
