"""chip_smoke.py's phases at tiny geometry on the CPU (the card runs
them at production geometry), its refusal of a machine without a GPU,
and its last line."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from vlite_fast.config import PipelineConfig, SearchConfig  # noqa: E402


@pytest.fixture(scope="module")
def tiny():
    cfg = PipelineConfig.tiny(inject_frb=True, nbit=2)
    return cfg, SearchConfig.tiny(), cs.noise_seconds(cfg, 4, seed=0)


def test_phases_tiny(tiny):
    cfg, scfg, secs = tiny
    cpu = jax.devices("cpu")[0]
    comp = cs.phase_compile(cfg, scfg)
    assert set(comp) == {"chain_armed", "chain_twin", "gulp_search"}
    assert comp["gulp_search"]["engine"] == "subband"
    assert comp["chain_armed"]["memory"]["temp_size_in_bytes"] > 0
    chain_cfg = dataclasses.replace(cfg, inject_frb=False)
    par = cs.phase_chain_parity(chain_cfg, secs[:2], cpu, cpu)
    assert par["agreement"] >= cs.PARITY_BAR
    assert "F32_F32_F32" in par["precision_high"]["matches"]
    assert len(par["oracle"]) == 2
    dd = cs.phase_dedisp_parity(cfg, scfg, cpu, seed=1)
    assert dd["ok"] and dd["max_abs_vs_reference"] == 0.0
    assert dd["ref_trials"] == 32


def test_timings_and_end_to_end_tiny(tiny):
    cfg, scfg, secs = tiny
    cpu = jax.devices("cpu")[0]
    chain_cfg = dataclasses.replace(cfg, inject_frb=False)
    oracle = cs.run_chain(dataclasses.replace(chain_cfg,
                                              dft_precision="highest"),
                          secs[:2], cpu)
    t = cs.phase_timings(chain_cfg, scfg, secs[:2], oracle, cpu,
                         engines=("subband",), seg_variants=(10, 5))
    assert t["dedisp_s_per_gulp"]["subband"] > 0
    assert set(t["search_stage_s"]) == {"dequantize", "boxcar", "topk",
                                        "gulp_program"}
    assert set(t["chain"]) == {"matmul_seg10", "fft_seg10", "matmul_seg5"}
    assert t["chain"]["matmul_seg10"]["agreement_vs_oracle"] == 1.0
    e2e = cs.phase_end_to_end(cfg, scfg, secs, nsec=4)
    assert e2e["data_seconds"] == 4 and e2e["gulps_searched"] >= 1
    assert e2e["antennas_per_card"] > 0


def test_levels_and_agreement():
    a = np.array([[0b11100100]], np.uint8)
    assert cs.levels(a, 2).tolist() == [[[0, 1, 2, 3]]]
    b = np.array([[0b11100111]], np.uint8)
    assert cs.agreement(a, b, 2) == 0.75


def test_result_line():
    line = cs.result_line({"platform": "gpu",
                           "kind": "NVIDIA H100 80GB HBM3", "count": 1})
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


def test_main_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as exc:
        cs.main([])
    assert "needs a GPU" in str(exc.value.code)
    assert '"ok"' not in capsys.readouterr().out


def test_script_alone_fails(tmp_path):
    """Without the rest of the repo the script exits non-zero and prints
    no result."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
