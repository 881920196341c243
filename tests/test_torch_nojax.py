"""tputracer_torch runs where JAX is not installed.

A fresh interpreter refuses every import of ``jax``, ``jaxlib`` and the JAX
package ``tputracer``, then imports tputracer_torch, builds the Cornell
boxes scene and renders it on the CPU, imports tputracer_torch.graphs (the
compiled entry points' CUDA graphs; nothing is captured on the CPU),
renders the caustics scene with BDPT,
single shot and progressive, then builds a clustered mesh scene
(with the native BVH builder and with the NumPy one) and renders that,
then takes a gradient through tputracer_torch.lookup, takes gradients
with grad_render and runs a two-step fit, then imports
tputracer_torch.dist and renders with render_sharded in a gloo world of
one.
"""

import os
import subprocess
import sys

SCRIPT = r"""
import importlib.abc
import sys

BLOCKED = ("jax", "jaxlib", "tputracer")


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked in this test")
        return None


for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]
sys.meta_path.insert(0, Refuse())

import torch
import tputracer_torch
from tputracer_torch.api import render
from tputracer_torch.config import RenderConfig
from tputracer_torch.scene import cornell_box

torch.set_num_threads(2)
img, stats = render(cornell_box("boxes", device="cpu"),
                    RenderConfig(width=8, height=8, spp=1), device="cpu")
assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
assert float(img.mean()) > 0.0

# the compiled entry points' machinery: on the CPU nothing is captured
from tputracer_torch import graphs

hash(graphs.graph_key("_render_jit", RenderConfig(width=8, height=8, spp=1),
                      cornell_box("boxes", device="cpu")))
assert graphs.CAPTURES == 0 and not graphs.graphs()
graphs.clear()

# BDPT, single shot and progressive
import numpy as np
from tputracer_torch.api import render_bdpt, render_bdpt_progressive
from tputracer_torch.config import BdptConfig

bcfg = BdptConfig(width=8, height=8, spp=2, max_bounces=2, chunk_size=128)
caustic = cornell_box("caustic", device="cpu")
img_b, stats_b = render_bdpt(caustic, bcfg, device="cpu")
assert img_b.shape == (8, 8, 3) and bool(torch.isfinite(img_b).all())
assert float(img_b.mean()) > 0.0 and float(stats_b["rays_closest"]) > 0.0
img_p, done = render_bdpt_progressive(caustic, bcfg, spp_per_pass=1,
                                      device="cpu")
assert done == 2
np.testing.assert_allclose(img_p, img_b.numpy(), rtol=1e-5, atol=1e-7)

# the mesh path: BVH build (native and NumPy), mesh builder, clustered walk
import os
from tputracer_torch.accel import bvh
from tputracer_torch.scene import mesh_scene

for no_native in ("", "1"):
    os.environ["TPUTRACER_NO_NATIVE"] = no_native
    mesh = mesh_scene(subdiv=2, leaf_size=32, accel="cluster", device="cpu")
    assert mesh.n_clusters > 0, mesh.n_clusters
    print("builder", bvh.LAST_BUILDER)
img, stats = render(mesh, RenderConfig(width=8, height=8, spp=1),
                    device="cpu")
assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
assert float(img.mean()) > 0.0

# the lookups' module, its one-hot backward, gradients and a two-step fit
from tputracer_torch import grad_render, lookup
from tputracer_torch.fit import fit

tab = torch.rand((6, 3), requires_grad=True)
lookup.fetch(tab, torch.tensor([0, 5, 5])).sum().backward()
assert tab.grad[:, 0].tolist() == [1.0, 0.0, 0.0, 0.0, 0.0, 2.0]

boxes = cornell_box("boxes", device="cpu")
gcfg = RenderConfig(width=8, height=8, spp=1, max_bounces=2, remat=True)
target, _ = render(boxes, gcfg)
start = {"mat_albedo": boxes.mat_albedo * 0.5}
loss, grads = grad_render(boxes, start, target, gcfg)
assert float(loss) > 0.0 and bool(torch.isfinite(grads["mat_albedo"]).all())
_, params, history = fit(boxes, target, cfg=gcfg, steps=2, init=start,
                         log_every=0)
assert [h["step"] for h in history] == [0, 1]
assert not torch.equal(params["mat_albedo"], start["mat_albedo"])

# distribution: a gloo world of one renders the same bits
import tempfile
from tputracer_torch.dist import launch, make_mesh, render_sharded

with tempfile.TemporaryDirectory() as tmp:
    launch.initialize(f"file://{tmp}/world", 1, 0, backend="gloo")
    try:
        img_d, _ = render_sharded(boxes, gcfg, make_mesh())
    finally:
        launch.shutdown()
assert torch.equal(img_d, target)
leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not leaked, leaked
print("OK", float(img.mean()))
"""


def test_port_imports_and_renders_without_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[-1].startswith("OK"), proc.stdout
    assert lines[-2] == "builder numpy", proc.stdout


def test_blocker_refuses_jax():
    """The finder really blocks: importing tputracer fails under it."""
    probe = SCRIPT.split("import torch")[0] + "import tputracer\n"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", probe], cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "blocked" in proc.stderr
