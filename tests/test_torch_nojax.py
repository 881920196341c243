"""tputracer_torch runs where JAX is not installed.

A fresh interpreter refuses every import of ``jax``, ``jaxlib`` and the JAX
package ``tputracer``, then imports tputracer_torch, builds the Cornell
boxes scene and renders it on the CPU.
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
img, stats = render(cornell_box("boxes"),
                    RenderConfig(width=8, height=8, spp=1), device="cpu")
assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
assert float(img.mean()) > 0.0
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
    assert proc.stdout.startswith("OK"), proc.stdout


def test_blocker_refuses_jax():
    """The finder really blocks: importing tputracer fails under it."""
    probe = SCRIPT.split("import torch")[0] + "import tputracer\n"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", probe], cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "blocked" in proc.stderr
