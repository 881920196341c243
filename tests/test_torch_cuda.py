"""The CUDA intersection kernel against its plain version, on the card.

These tests need a CUDA card and skip without one. They import neither
JAX nor the JAX package, so they also run where JAX is not installed; on
the card, run them without the JAX-pinning conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from tputracer_torch.accel import intersect_cuda as ic
from tputracer_torch.accel import intersect_plain, occluded_plain
from tputracer_torch.config import RenderConfig
from tputracer_torch.integrators.pt import render_pt
from tputracer_torch.scene import cornell_box

BIG = 3.0e38


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def random_rays(n, seed):
    r = np.random.default_rng(seed)
    o = r.uniform(0.02, 0.98, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.zeros(n, np.float32)
    tmax = np.full(n, BIG, np.float32)
    tocc = r.uniform(0.0, 1.5, n).astype(np.float32)
    tmax[::4] = 0.0
    tocc[::4] = 0.0
    return tuple(torch.from_numpy(x).cuda() for x in (o, d, tmin, tmax, tocc))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["boxes", "spheres"])
def test_cuda_kernel_matches_plain(variant):
    """Built with -fmad=false and summed in the plain version's order, the
    kernel gives the same t and prim bit for bit; a ragged ray count
    (not a multiple of the block) included."""
    need_card()
    args = ic.scene_args(cornell_box(variant, device="cuda"))
    o, d, tmin, tmax, tocc = random_rays(100_003, seed=7)
    launches = ic.LAUNCHES
    t_k, p_k = ic.fused_intersect_cuda(o, d, tmin, tmax, *args)
    t_p, p_p = ic.fused_intersect_plain(o, d, tmin, tmax, *args)
    torch.cuda.synchronize()
    assert ic.LAUNCHES == launches + 1
    assert torch.equal(p_k, p_p)
    assert torch.equal(t_k, t_p)
    assert torch.equal(t_k[p_k < 0], tmax[p_k < 0])
    zeros = torch.zeros_like(tocc)
    t_a, _ = ic.fused_intersect_cuda(o, d, zeros, tocc, *args, any_hit=True)
    t_q, _ = ic.fused_intersect_plain(o, d, zeros, tocc, *args)
    assert torch.equal(t_a < tocc, t_q < tocc)


@pytest.mark.cuda
def test_cuda_render_goes_through_kernel():
    """A render on the card launches the kernel 2*bounces+1 times per
    chunk and gives the image of the same render through the plain
    version."""
    need_card()
    sc = cornell_box("boxes", device="cuda")
    cfg = RenderConfig(width=32, height=32, spp=4, max_bounces=4)
    launches = ic.LAUNCHES
    img_k, _ = render_pt(sc, cfg)
    torch.cuda.synchronize()
    assert ic.LAUNCHES == launches + 2 * cfg.max_bounces + 1
    img_p, _ = render_pt(sc, cfg, intersect_fn=intersect_plain,
                         occluded_fn=occluded_plain)
    assert torch.equal(img_k, img_p)
    assert bool(torch.isfinite(img_k).all()) and float(img_k.mean()) > 0.1
