"""``perfbench/run.py`` as a benchmark run calls it: without a card it exits
non-zero and prints no result; on a card (marked ``cuda``, skipped
elsewhere) each single-card cell prints the contract's last line."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def run(cell, seconds, trace, env=None):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
         str(2**31 + 11), "--seconds", str(seconds), "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=900, env=env)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def test_no_card_no_result():
    import os

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = run("boxes_turntable", 1, 0, env)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", ["boxes_turntable", "mesh_turntable",
                                  "boxes_fit"])
def test_a_cell_prints_the_contract_line(card, cell, trace):
    proc = run(cell, 2, trace)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in bench[kind]
            if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) <= want
    if not trace:
        assert set(line["metrics"]) == want
    else:
        assert line["device"]["busy_s"] > 0
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert proc.stderr.strip().splitlines()[-1].startswith("check ")
