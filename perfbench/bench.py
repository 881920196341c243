"""The benchmark's definition, found by name from ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names its configuration and its
traffic; the harness finds each by that name:

  * ``configs[].file``: the configuration (scene generator, sizes,
    materials, camera, the precision it states);
  * ``perfbench/traffic/<traffic>.json``: the traffic's parameters,
    among them its ``kind``;
  * ``perfbench/kinds/<kind>.py``: the traffic kind, a class ``Kind``
    (a ``drive.Run``) that makes the kind's calls of the program, times
    its units, judges them and plants its calibration faults;
  * ``perfbench/cells/<workload>.json``: the limits of the comparison
    that decides ``correct``, with the readings they were set from;
  * ``perfbench/metrics/<metric>.py``: a per-layer metric's reader,
    ``read(stretch) -> float | None``.

A later cell, configuration, traffic or metric is added with new files
and new entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclass
class Spec:
    name: str
    workload: dict
    config: dict
    traffic: dict
    cell: dict
    end_to_end: list      # the end-to-end metric entries this cell reports
    per_layer: list       # the per-layer metric entries this cell reports
    readers: dict         # per-layer metric name -> read(stretch)
    kind: type = None     # the traffic kind's Run class


def load_json(path):
    with open(path) as f:
        return json.load(f)


def reports(metric, cell, e2e_names=None):
    """Whether ``cell`` reports ``metric``: named in its ``workloads``, or,
    with no such key, every cell (a per-layer metric: every cell that
    reports the end-to-end metric it moves)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


_MODULES = {}


def module(folder, name, base=HERE):
    """The module of ``<base>/<folder>/<name>.py``, loaded once a path."""
    path = (Path(base) / folder / f"{name}.py").resolve()
    if path not in _MODULES:
        spec = importlib.util.spec_from_file_location(
            f"perfbench.{folder}.{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


def reader(name, base=HERE):
    """``read`` of ``<base>/metrics/<name>.py``."""
    return module("metrics", name, base).read


def kind(name, base=HERE):
    """``Kind`` of ``<base>/kinds/<name>.py``."""
    return module("kinds", name, base).Kind


def load(root, workload, bench=None, base=HERE):
    """The Spec of cell ``workload`` of the benchmark at ``root`` (or of
    the ``bench`` dict given in its place), its traffic, cell and metric
    files under ``base``."""
    root, base = Path(root), Path(base)
    bench = bench or load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(root / cfg_entry["file"])
    traffic = load_json(base / "traffic" / f"{w['traffic']}.json")
    cell = load_json(base / "cells" / f"{workload}.json")
    e2e = [m for m in bench["end_to_end"] if reports(m, workload)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if reports(m, workload, names)]
    return Spec(workload, w, config, traffic, cell, e2e, per_layer,
                {m["name"]: reader(m["name"], base) for m in per_layer},
                kind(traffic["kind"], base))
