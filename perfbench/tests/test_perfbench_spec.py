"""The benchmark's definition: every cell, configuration, traffic and
metric is found by name from BENCHMARK.json, the file keeps to the
benchmark contract's shape, and a new cell needs new files only."""

import json
import re
import shutil
import time
from pathlib import Path

import pytest
import torch

from perfbench import bench, drive, generator, scenes

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "perfbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"][1].startswith("perfbench/")
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    spec = bench.load(ROOT, cell)
    assert issubclass(spec.kind, drive.Run)
    assert (HERE / "kinds" / f"{spec.traffic['kind']}.py").exists()
    assert scenes.build(spec.config).tris.shape[0] == \
        spec.config["n_triangles"]
    assert set(spec.cell["limits"]) <= {"mean_rel", "bad_share", "loss_gap",
                                        "grad_gap", "change_gap"}
    names = {m["name"] for m in spec.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert spec.per_layer and all(callable(spec.readers[m["name"]])
                                  for m in spec.per_layer)


def test_entries_keep_to_the_contract():
    seen = set()
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("perfbench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = set()
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert (HERE / "metrics" / f"{m['name']}.py").exists()
        for cell in m.get("workloads", CELLS):
            assert bench.reports(e2e[m["moves"]], cell), (m["name"], cell)
        layers.add(m["layer"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in seen
        seen.add(m["name"])
    assert all("\n" not in x and len(x) <= 200 for x in layers)


def test_flat_ray_counts():
    tr = {w["name"]: bench.load(ROOT, w["name"]).traffic
          for w in BENCH["workloads"]}
    assert generator.flat_rays(tr["boxes_turntable"]) == 37_748_736
    assert generator.flat_rays(tr["mesh_turntable"]) == 4_456_448


STILL = '''
"""A still: the turntable's frames with the camera held at its first
angle, the light still rescaled a frame."""

from perfbench import bench, generator, program


class Kind(bench.kind("turntable")):
    def frame_scene(self, k):
        return program.with_tables(
            self.scene, camera=self.cams[self.tt.yaw_index(0)],
            mat_emission=self.base_em_dev
            * self.factors[k % generator.N_FACTORS])

    def origin_of(self, k):
        return self.tt.origins[self.tt.yaw_index(0)]
'''


def test_a_new_traffic_kind_needs_only_new_files(tmp_path):
    """A throwaway traffic kind, written here as a file of its own, with
    its traffic and cell: found by name and run whole on the CPU, with no
    harness file edited."""
    base = tmp_path / "perfbench"
    for d in ("traffic", "cells", "metrics", "kinds"):
        shutil.copytree(HERE / d, base / d)
    (base / "kinds" / "still.py").write_text(STILL)
    tr = json.loads((HERE / "traffic" / "turntable_512sq_16spp.json")
                    .read_text())
    tr["kind"] = "still"
    tr["render"].update(width=16, height=16, spp=2, chunk_size=256)
    tr["traced_frames"] = 2
    (base / "traffic" / "still_16sq.json").write_text(json.dumps(tr))
    shutil.copy(base / "cells" / "boxes_turntable.json",
                base / "cells" / "boxes_still.json")
    new = json.loads(json.dumps(BENCH))
    new["workloads"].append({"name": "boxes_still", "config":
                             "cornell_boxes", "traffic": "still_16sq",
                             "chips": 1, "why": "a throwaway cell"})
    for m in new["end_to_end"] + new["per_layer"]:
        if "boxes_turntable" in m.get("workloads", []):
            m["workloads"].append("boxes_still")
    spec = bench.load(ROOT, "boxes_still", bench=new, base=base)
    assert spec.kind.__module__ == "perfbench.kinds.still"
    assert issubclass(spec.kind, bench.kind("turntable"))
    out = drive.run(spec, 2**31 + 77, 0.3, True, torch.device("cpu"),
                    time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["per_layer"]["idle_pct.render"]


def test_a_new_cell_needs_only_new_files(tmp_path):
    """A throwaway cell, traffic, cell file and metric, defined here and
    found by name with no harness file edited."""
    base = tmp_path / "perfbench"
    for d in ("traffic", "cells", "metrics", "kinds"):
        shutil.copytree(HERE / d, base / d)
    tr = json.loads((HERE / "traffic" / "turntable_256sq_4spp.json")
                    .read_text())
    tr["render"]["spp"] = 8
    (base / "traffic" / "turntable_256sq_8spp.json").write_text(
        json.dumps(tr))
    (base / "cells" / "boxes_turntable_8spp.json").write_text(json.dumps(
        {"limits": {"mean_rel": 1.0, "bad_share": 1.0}}))
    (base / "metrics" / "frames_traced.py").write_text(
        "def read(st):\n    return float(len(st.units))\n")
    new = json.loads(json.dumps(BENCH))
    new["workloads"].append({"name": "boxes_turntable_8spp",
                             "config": "cornell_boxes",
                             "traffic": "turntable_256sq_8spp", "chips": 1,
                             "why": "a throwaway cell"})
    for m in new["end_to_end"]:
        if "rays_per_s" in m["name"] or "frame_ms" in m["name"]:
            m["workloads"].append("boxes_turntable_8spp")
    new["per_layer"].append({"name": "frames_traced", "unit": "frames",
                             "better": "higher", "source": "host_clock",
                             "layer": "Device (H100)", "moves": "rays_per_s",
                             "workloads": ["boxes_turntable_8spp"]})
    spec = bench.load(ROOT, "boxes_turntable_8spp", bench=new, base=base)
    assert spec.traffic["render"]["spp"] == 8
    assert generator.flat_rays(spec.traffic) == 256 * 256 * 8 * 17
    assert "frames_traced" in spec.readers
    assert spec.readers["frames_traced"](type("S", (), {"units": [1, 2]})) \
        == 2.0
    assert {m["name"] for m in spec.end_to_end} == {
        "rays_per_s", "frame_ms_p95", "setup_s"}
