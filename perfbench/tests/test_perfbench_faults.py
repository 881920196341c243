"""A run of each cell on the CPU at a small size, with the harness's look
for a card skipped: sound, it comes out correct; with the timed path
broken underneath, ``correct`` comes out false, once for each fault the
cell can have."""

import json
import time
from pathlib import Path

import pytest
import torch

from perfbench import bench, drive, program

ROOT = Path(__file__).resolve().parents[2]
SMALL = {"boxes_turntable": dict(width=16, height=16, spp=2),
         "mesh_turntable": dict(width=8, height=8, spp=2),
         "boxes_fit": dict(width=16, height=16, spp=2)}
SECONDS = {"boxes_turntable": 0.5, "mesh_turntable": 1.5, "boxes_fit": 0.3}


def small_spec(cell):
    spec = bench.load(ROOT, cell)
    spec.traffic = json.loads(json.dumps(spec.traffic))
    spec.traffic["render"].update(SMALL[cell], chunk_size=256)
    if spec.traffic["kind"] == "turntable":
        spec.traffic["check"].update(frames=3, pixels=64)
        spec.traffic["traced_frames"] = 2
    else:
        spec.traffic["chain"] = 2
    return spec


def run(cell, trace=False):
    return drive.run(small_spec(cell), 2**31 + 4242, SECONDS[cell], trace,
                     torch.device("cpu"), time.perf_counter())


def half_the_samples(monkeypatch):
    """The film averages the first half of each pixel's samples only."""
    from tputracer_torch.integrators import pt

    def film(L, cfg, rows=None, flip=True):
        rows = cfg.height if rows is None else rows
        img = L.reshape(rows, cfg.width, cfg.spp, 3)[:, :, :cfg.spp // 2]
        img = img.mean(dim=2)
        return torch.flip(img, dims=(0,)) if flip else img

    monkeypatch.setattr(pt, "film_from_radiance", film)


def answer_altered(monkeypatch):
    """The frame's image one percent off where the program makes it."""
    render = program.render
    monkeypatch.setattr(program, "render",
                        lambda sc, cfg: render(sc, cfg) * 1.01)


def state_unchanged(monkeypatch):
    """Each frame renders the set-up's scene: the camera and light edits
    never reach the program."""
    monkeypatch.setattr(program, "with_tables",
                        lambda scene, camera=None, **tables: scene)


def fit_state_unchanged(monkeypatch):
    """The optimizer steps leave the parameters as they were."""
    from tputracer_torch import fit

    adam = fit._adam
    monkeypatch.setattr(fit, "_adam", lambda params, lr: adam(params, 0.0))


def loss_altered(monkeypatch):
    """The fit's loss one percent off where the program makes it."""
    from tputracer_torch import api

    l2 = api._loss_l2
    monkeypatch.setattr(api, "_loss_l2", lambda img, t: 1.01 * l2(img, t))


RENDER_FAULTS = [answer_altered, state_unchanged, half_the_samples]
FIT_FAULTS = [fit_state_unchanged, half_the_samples, loss_altered]


@pytest.mark.parametrize("cell", list(SMALL))
def test_a_sound_run_is_correct(cell):
    out = run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["e2e"]["setup_s"] > 0


@pytest.mark.parametrize("fault", RENDER_FAULTS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", ["boxes_turntable", "mesh_turntable"])
def test_a_broken_render_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = run(cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", FIT_FAULTS, ids=lambda f: f.__name__)
def test_a_broken_fit_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out = run("boxes_fit")
    assert not out["correct"], out["checks"]


def test_a_traced_run_reads_its_stretch():
    out = run("boxes_turntable", trace=True)
    assert out["correct"]
    assert out["per_layer"]["dispatch_host_ms"] > 0
    assert out["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
