"""The port's path tracer on clustered mesh scenes, against tputracer's.

The renders go through the cluster BVH in both packages (the plain
clustered walk on the CPU) and draw the same counter-based random numbers,
so they are held to the golden tolerances of
tests/golden/test_pt_vs_oracle.py: mean relative error < 5e-4 and < 1% of
pixels beyond 5e-3 relative.  The per-bounce ray counts (closest-hit,
shadow, alive) are equal.
"""

import json

import numpy as np
import pytest
import torch

from tputracer.api import render as jax_render
from tputracer.config import RenderConfig as JaxRenderConfig
from tputracer.scene.mesh import mesh_scene as jax_mesh_scene
from tputracer_torch import cli
from tputracer_torch.api import render
from tputracer_torch.config import RenderConfig
from tputracer_torch.scene import mesh_scene
from test_torch_bvh import MTL, OBJ_MTL
from test_torch_pt import golden_compare


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)


MESH = [
    dict(width=12, height=12, spp=2, max_bounces=3, rr_start=2),
    dict(width=12, height=12, spp=2, max_bounces=3, rr_start=2, seed=3,
         mis=True),
]


@pytest.mark.parametrize("kw", MESH, ids=["nee", "mis"])
def test_mesh_render_matches_jax(kw):
    js = jax_mesh_scene(subdiv=3, leaf_size=32, accel="cluster")
    ts = mesh_scene(subdiv=3, leaf_size=32, accel="cluster", device="cpu")
    assert ts.n_clusters > 8
    img_j, stats_j = jax_render(js, JaxRenderConfig(**kw))
    img_t, stats_t = render(ts, RenderConfig(**kw))
    assert img_t.shape == (kw["height"], kw["width"], 3)
    golden_compare(img_t.numpy(), np.asarray(img_j))
    for k in ("alive", "rays_closest", "rays_shadow"):
        np.testing.assert_array_equal(stats_t[k].numpy(),
                                      np.asarray(stats_j[k]), err_msg=k)


def test_mesh_render_chunking_is_invisible():
    ts = mesh_scene(subdiv=2, leaf_size=32, accel="cluster", device="cpu")
    cfg = RenderConfig(width=8, height=8, spp=2, max_bounces=3)
    a, _ = render(ts, cfg)
    b, _ = render(ts, cfg.with_(chunk_size=32))
    assert torch.equal(a, b)
    assert float(a.mean()) > 1e-3


@pytest.mark.parametrize("argv", [
    ["--scene", "mesh_small"],
    ["--obj", "OBJ"],
], ids=["mesh_small", "obj"])
def test_cli_mesh_scenes_on_cpu(argv, tmp_path, capsys):
    if argv[0] == "--obj":
        (tmp_path / "m.mtl").write_text(MTL)    # it holds the light
        path = tmp_path / "m.obj"
        path.write_text("mtllib m.mtl\n" + OBJ_MTL)
        argv = ["--obj", str(path)]
    out = tmp_path / "out.png"
    cli.main(argv + ["--size", "8", "--spp", "1", "--bounces", "1",
                     "--device", "cpu", "--out", str(out)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out.exists() and line["size"] == 8
    assert np.isfinite(line["mean"]) and line["render_s"] > 0.0
