"""What the benchmark runs imports neither JAX nor the JAX package
(``tputracer``, compared by whole top-level name, so ``tputracer_torch``
is allowed), nor ``optax``; the reference imports nothing of the program;
no harness file reads ``benchmarks/`` or ``bench.py``."""

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "perfbench"

BLOCKER = """
import importlib.abc, sys
BARRED = {barred!r}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BARRED:
            raise ImportError("barred: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, {root!r})
"""


def run_blocked(barred, body):
    code = BLOCKER.format(barred=set(barred), root=str(ROOT)) + \
        textwrap.dedent(body)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


@pytest.mark.parametrize("cell", ["boxes_turntable", "mesh_turntable",
                                  "boxes_fit"])
def test_a_cells_set_up_imports_no_jax(cell):
    out = run_blocked(("jax", "jaxlib", "flax", "optax", "tputracer"), f"""
        import time, json, torch
        from perfbench import bench, drive, run
        spec = bench.load({str(ROOT)!r}, {cell!r})
        spec.traffic["render"].update(width=8, height=8, spp=1,
                                      chunk_size=64)
        if spec.traffic["kind"] == "fit":
            spec.traffic["chain"] = 1
        r = spec.kind(spec, 3, torch.device("cpu"))
        r.setup()
        mods = {{m.split(".")[0] for m in sys.modules}}
        print(json.dumps([run.barred_modules(),
                          "tputracer_torch" in mods]))
    """)
    assert out.strip().splitlines()[-1] == '[[], true]'


def test_the_reference_imports_nothing_of_the_program():
    out = run_blocked(("jax", "jaxlib", "flax", "optax", "tputracer",
                       "tputracer_torch"), """
        import torch
        from perfbench import check, generator, scenes
        from perfbench.reference import fit, pt
        import json
        cfg = json.load(open("perfbench/configs/cornell_boxes.json"))
        arrays = scenes.build(cfg)
        r = dict(width=8, height=8, spp=1, max_bounces=2, rr_start=1)
        px = check.reference_pixels(arrays, cfg, r, 1,
            generator.material_tables(arrays.materials)["mat_emission"],
            cfg["camera"]["o"], list(range(64)), torch.device("cpu"),
            torch.float32)
        print(float(px.mean()) > 0)
    """)
    assert out.strip().splitlines()[-1] == "True"


def imported_tops(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def imported_modules(path):
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods |= {node.module} | {f"{node.module}.{a.name}"
                                     for a in node.names}
    return mods


def test_no_harness_file_imports_the_old_benchmarks_or_jax():
    files = [p for p in HERE.rglob("*.py") if "tests" not in p.parts]
    assert files
    for p in files:
        tops = imported_tops(p)
        assert not tops & {"jax", "jaxlib", "flax", "optax", "tputracer",
                           "benchmarks", "bench", "chip_smoke",
                           "chip_profile"}, p
        if "reference" in p.parts:
            assert "tputracer_torch" not in tops, p
            assert "perfbench.program" not in imported_modules(p), p
        text = p.read_text()
        assert "benchmarks/" not in text.replace("benchmarks/run.py:", ""), p
