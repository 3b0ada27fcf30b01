"""True multi-controller tests: two OS processes = two 'hosts' wired into
one mesh by jax.distributed; each contributes its local antennas and the
collectives cross the process boundary (the DCN path, SURVEY section 5 —
the closest this environment gets to configs[4]'s N>=2 hosts).

test_two_process_coadd       — minimal psum across the boundary.
test_two_process_array_step  — the FULL production sharded step
    (build_array_step) on a (ant=2, time=2) mesh split 2 devices/process:
    all_to_all reshard, ppermute halos, psum coadd and both top-k searches
    all ride the inter-process path, and the decoded candidate plane must
    MATCH a single-process run of the identical geometry and seed.
"""

import json
import os
import subprocess
import sys

import pytest

WORKER = os.path.join(os.path.dirname(__file__), "multihost_worker.py")


def _run_workers(mode, port, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(WORKER))
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(pid), "2", str(port), mode],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
        for pid in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            pytest.fail("multihost worker hung")
        assert p.returncode == 0, f"worker failed: {err[-1500:]}"
        outs.append(json.loads(out.strip().splitlines()[-1]))
    return outs


def test_two_process_coadd():
    outs = _run_workers("coadd", 39765, timeout=120)
    for o in outs:
        assert o["devices"] == 4 and o["local_devices"] == 2
        assert all(abs(c - 5.0) < 1e-5 for c in o["coadd_means"])


@pytest.mark.slow
def test_two_process_observation_soak():
    """VERDICT r4 item 8: a full multi-second observation across 2 real
    processes end to end — VDIF capture-replay, armed + plain sharded
    steps with carried state, candidate extraction, and cross-process
    TCP candidate shipping into the coincidencer, whose min_beams=3 cut
    can only be satisfied once BOTH processes' beams have reported
    (ref scripts/start_coadd:22-57 topology)."""
    outs = _run_workers("observation", 39771, timeout=600)
    by_pid = {o["pid"]: o for o in outs}
    for o in outs:
        assert o["devices"] == 4 and o["local_devices"] == 2
        # capture plane was lossless at wire framing
        assert o["cap"]["skipped"] == 0 and o["cap"]["anomalous"] == 0
        # armed call recovered the burst in every beam + coadd (the
        # worker asserts DM accuracy; the summary carries the counts)
        assert o["calls"][0]["beams_with_cands"] == 4
        assert o["calls"][0]["coadd_cands"] >= 1
    # both processes computed the identical observation
    for k in range(2):
        assert by_pid[0]["calls"][k]["packed_sha"] == \
            by_pid[1]["calls"][k]["packed_sha"], k
    # the coincidencer (process 0) triggered on the injected burst with
    # >=3 coincident beams — impossible without process 1's shipment
    trigs = by_pid[0]["triggers"]
    assert trigs and any("nbeam3" in t["meta"] or "nbeam4" in t["meta"]
                         for t in trigs), trigs


@pytest.mark.slow
def test_two_process_array_step():
    """VERDICT r2 item 7: the production SPMD candidate plane across a
    real process boundary must equal the single-process virtual-mesh run
    bit-for-bit (packed bytes) and candidate-for-candidate."""
    import jax

    import multihost_worker as mw

    outs = _run_workers("arraystep", 39767)
    for o in outs:
        assert o["devices"] == 4 and o["local_devices"] == 2

    # both processes decode the identical replicated output
    for key in ("packed_sha", "per_beam", "coadd", "weights_mean"):
        assert outs[0][key] == outs[1][key], key

    # single-process reference: same geometry/seed on 4 local devices
    from vlite_fast.parallel.mesh import make_mesh
    mesh = make_mesh(n_ant=2, n_time=2, devices=jax.devices()[:4])
    ref = mw.arraystep_summary(mw.arraystep_config(), mesh)

    assert outs[0]["packed_sha"] == ref["packed_sha"]
    assert outs[0]["weights_mean"] == ref["weights_mean"]
    assert outs[0]["coadd"] == ref["coadd"]
    assert outs[0]["per_beam"] == ref["per_beam"]
    assert outs[0]["stats"]["n_crossings"] == ref["stats"]["n_crossings"]
