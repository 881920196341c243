"""The frozen scene generators give the program the scenes of its own
builders: ``cornell_box("boxes")`` and ``mesh_scene(subdiv=6)``, with the
same triangle counts, bounds and tables."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import program, scenes

ROOT = Path(__file__).resolve().parents[2]


def config(name):
    return json.loads((ROOT / "perfbench" / "configs" / f"{name}.json")
                      .read_text())


def builders():
    from tputracer_torch.scene.cornell import cornell_box
    from tputracer_torch.scene.mesh import mesh_scene

    return {"cornell_boxes": (lambda: cornell_box("boxes", device="cpu"),
                              36, 0),
            "mesh_subdiv6": (lambda: mesh_scene(6, device="cpu"), 102_410,
                             1160)}


@pytest.mark.parametrize("name", ["cornell_boxes", "mesh_subdiv6"])
def test_frozen_generator_builds_the_programs_scene(name):
    build, n_tris, n_clusters = builders()[name]
    cfg = config(name)
    arrays = scenes.build(cfg)
    assert arrays.tris.shape == (n_tris, 3, 3) == (cfg["n_triangles"], 3, 3)
    ours = program.build_scene(arrays, cfg, "cpu")
    theirs = build()
    assert ours.n_tris == theirs.n_tris == n_tris
    assert ours.n_clusters == theirs.n_clusters == n_clusters
    valid = theirs.tri_mask > 0
    for f in ("tri_v0", "tri_e1", "tri_e2", "tri_n", "tri_mat", "tri_mask",
              "plu", "mat_kind", "mat_albedo", "mat_emission", "mat_ior",
              "emit_prim", "emit_area", "emit_v0", "emit_n", "clus_min",
              "clus_max"):
        assert torch.equal(getattr(ours, f), getattr(theirs, f)), f
    for f in ("o", "corner", "du", "dv"):
        assert torch.equal(getattr(ours.camera, f),
                           getattr(theirs.camera, f)), f
    lo = theirs.tri_v0[valid].amin(0)
    assert torch.equal(torch.as_tensor(arrays.tris.reshape(-1, 3).min(0)),
                       torch.minimum(lo, torch.minimum(
                           (theirs.tri_v0 + theirs.tri_e1)[valid].amin(0),
                           (theirs.tri_v0 + theirs.tri_e2)[valid].amin(0))))


def test_the_turntables_first_camera_is_the_published_one():
    from perfbench import generator

    for name in ("cornell_boxes", "mesh_subdiv6"):
        cfg = config(name)
        tt = generator.Turntable({"yaw_deg": 15, "step_deg": 1,
                                  "light_scale": [0.5, 2.0]},
                                 cfg["camera"], 1)
        assert np.array_equal(tt.origins[15],
                              np.asarray(cfg["camera"]["o"], np.float32))
