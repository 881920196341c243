"""Golden tests of tputracer_torch's path tracer against exact references.

The NumPy oracle (tests/oracle/oracle_pt.py, a path-by-path tracer
independent of both packages) reads the port's scene tensors and draws the
same counter-based random numbers, so the images agree pixel by pixel up to
float32 noise plus rare decision flips: the tolerances of
tests/golden/test_pt_vs_oracle.py.  The furnace scene has an analytic
answer (tests/golden/test_furnace.py).
"""

import numpy as np
import pytest
import torch

from oracle.oracle_pt import oracle_render
from tputracer_torch.api import render
from tputracer_torch.config import RenderConfig
from tputracer_torch.scene import cornell_box, furnace


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)


GOLDEN = [
    ("boxes", dict(width=24, height=24, spp=4, max_bounces=4, rr_start=2,
                   seed=5)),
    ("spheres", dict(width=20, height=20, spp=4, max_bounces=5, rr_start=2,
                     seed=9)),
    ("boxes", dict(width=24, height=24, spp=4, max_bounces=4, rr_start=2,
                   seed=13, mis=True)),
    ("spheres", dict(width=20, height=20, spp=4, max_bounces=5, rr_start=2,
                     seed=17, mis=True)),
]


@pytest.mark.parametrize("variant, kw", GOLDEN,
                         ids=["boxes", "spheres", "boxes_mis", "spheres_mis"])
def test_pt_matches_oracle(variant, kw):
    """The port's render against the oracle's on the same scene tensors:
    mean rel < 5e-4, outlier share (rel > 5e-3) < 1%; glass and mirror
    lanes (spheres) and the power-heuristic MIS included."""
    scene = cornell_box(variant, device="cpu")
    cfg = RenderConfig(**kw)
    img = render(scene, cfg)[0].numpy()
    ref = oracle_render(scene, cfg)
    rel = np.abs(img - ref) / (1.0 + np.abs(ref))
    assert float(rel.mean()) < 5e-4, f"mean rel err {rel.mean():.2e}"
    assert float((rel > 5e-3).mean()) < 0.01
    assert img.mean() > 1e-3


def test_mis_converges_to_nee():
    """MIS and NEE alone estimate the same integral: their image means
    agree within 3% at 64 spp (catches sign or normalization errors that
    the shared-stream pixel tests cannot see)."""
    scene = cornell_box("boxes", device="cpu")
    base = RenderConfig(width=16, height=16, spp=64, max_bounces=3,
                        rr_start=3, seed=21)
    a = float(render(scene, base)[0].mean())
    b = float(render(scene, base.with_(mis=True))[0].mean())
    assert abs(a - b) / a < 0.03, (a, b)


def test_furnace_energy():
    """A convex diffuse sphere (albedo rho) inside a uniformly emissive box
    (radiance L) reflects exactly rho * L: the central pixels within 2%,
    and the corners, which see the wall, equal L to rtol 1e-5."""
    rho, L = 0.6, 1.0
    scene = furnace(albedo=rho, emission=L, device="cpu")
    cfg = RenderConfig(width=16, height=16, spp=128, max_bounces=2,
                       rr_start=99, seed=3, chunk_size=1 << 15)
    img = render(scene, cfg)[0].numpy()
    np.testing.assert_allclose(img[5:11, 5:11].mean(), rho * L, rtol=0.02)
    corners = np.stack([img[0, 0], img[0, -1], img[-1, 0], img[-1, -1]])
    np.testing.assert_allclose(corners, L, rtol=1e-5)
