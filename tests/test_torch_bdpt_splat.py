"""BDPT's t = 1 splat route on the CPU (``bdpt.t1_splats``).

CPU vertices, and calls that want a gradient, take the torch version,
``t1_splats_plain``, bit for bit and without a launch; the card's wrapper
(``integrators.bdpt_cuda.t1_splats_cuda``) refuses CPU vertices, tensors
of another layout and a camera tensor of another dtype or shape before it
builds anything; its strategy list is the torch version's loop order.
The kernels themselves run on the card only
(``tests/test_torch_cuda.py -k splat``).
"""

import dataclasses

import pytest
import torch

from tputracer_torch import cuda_build, trace
from tputracer_torch.config import BdptConfig
from tputracer_torch.integrators import bdpt, bdpt_cuda
from tputracer_torch.scene import cornell_box

CFG = BdptConfig(width=16, height=16, spp=2, max_bounces=4)


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def vertices(name="caustic", lanes=512, cfg=CFG, scene=None):
    sc = cornell_box(name, device="cpu") if scene is None else scene
    uid = torch.arange(lanes, dtype=torch.int64)
    return sc, bdpt.light_subpaths(sc, uid, cfg), bdpt.eye_subpaths(sc, uid,
                                                                     cfg)


@pytest.mark.parametrize("power", [False, True], ids=["balance", "power"])
@pytest.mark.parametrize("name", ["caustic", "spheres"])
def test_cpu_vertices_take_the_torch_route(name, power):
    """On the CPU t1_splats is t1_splats_plain: the same film and
    shadow-ray count bit for bit, no kernel launched, and the chunk's
    bdpt.splat span counts kernel 0."""
    cfg = CFG.with_(mis_power=power)
    sc, ys, zs = vertices(name, cfg=cfg)
    assert not bdpt.bdpt_on_card(sc, ys, zs)
    launches = cuda_build.LAUNCHES.copy()
    got, want = {}, {}
    film = bdpt.t1_splats(sc, cfg, ys, zs, stats_acc=got)
    film_p = bdpt.t1_splats_plain(sc, cfg, ys, zs, stats_acc=want)
    assert cuda_build.LAUNCHES == launches
    assert film.shape == (cfg.width * cfg.height, 3)
    assert torch.equal(film, film_p) and torch.equal(got["rays_shadow"],
                                                     want["rays_shadow"])
    assert float(film.sum()) > 0.0
    trace.reset()
    bdpt.trace_bdpt(sc, torch.arange(256, dtype=torch.int64), cfg)
    (rec,) = trace.records("bdpt.splat")
    assert rec.counts == {"lanes": 256, "strategies": 5, "kernel": 0}
    trace.reset()


def test_gradient_calls_take_the_torch_route():
    """A call with grad enabled and the albedo requiring grad takes the
    torch route: the film of the call without a gradient, bit for bit,
    with a graph back to the albedo."""
    sc = cornell_box("caustic", device="cpu")
    albedo = sc.mat_albedo.clone().requires_grad_()
    graded = dataclasses.replace(sc, mat_albedo=albedo)
    sc_g, ys, zs = vertices(scene=graded, lanes=256)
    assert not bdpt.bdpt_on_card(sc_g, ys, zs)
    film = bdpt.t1_splats(sc_g, CFG, ys, zs)
    assert film.requires_grad
    (grad,) = torch.autograd.grad(film.sum(), albedo)
    assert bool(torch.isfinite(grad).all()) and float(grad.abs().sum()) > 0
    with torch.no_grad():
        _, ys0, zs0 = vertices(scene=sc, lanes=256)
        assert torch.equal(film.detach(),
                           bdpt.t1_splats_plain(sc, CFG, ys0, zs0))


def test_other_devices_have_no_splat_route():
    """A device that is neither the CPU nor CUDA raises, before any work."""
    sc, ys, zs = vertices(lanes=8)
    meta = [{k: torch.empty_like(x, device="meta") for k, x in v.items()}
            for v in zs]
    with pytest.raises(ValueError, match="no BDPT kernel route"):
        bdpt.bdpt_on_card(sc, ys, meta)


def test_the_wrapper_refuses_before_any_build(monkeypatch):
    """t1_splats_cuda raises ValueError on CPU vertices, on a vertex tensor
    that is not contiguous, not of its dtype or not of the chunk's length,
    and on a camera tensor not a float32 (3,) vector on the vertices'
    device, before it builds or launches anything."""
    def no_build():
        raise AssertionError("built the kernels")

    monkeypatch.setattr(bdpt_cuda.LIB, "load", no_build)
    sc, ys, zs = vertices(lanes=64)
    with pytest.raises(ValueError, match="t1_splats_cuda: want CUDA "
                                         "vertices, got cpu"):
        bdpt_cuda.t1_splats_cuda(sc, CFG, ys, zs)
    strided = torch.empty((64, 6))[:, :3]
    for vert, field, bad, why in (
            (2, "p", strided, "not contiguous"),
            (0, "ng", strided, "not contiguous"),
            (1, "pdf_rev", ys[1]["pdf_rev"].double(), "torch.float64"),
            (3, "mat", ys[3]["mat"].long(), "torch.int64"),
            (1, "delta", ys[1]["delta"][:32], r"\(32,\)")):
        kept = ys[vert][field]
        ys[vert][field] = bad
        try:
            with pytest.raises(ValueError, match=why):
                bdpt_cuda.t1_splats_cuda(sc, CFG, ys, zs)
        finally:
            ys[vert][field] = kept
    cam = sc.camera
    for field, bad, why in (
            ("o", cam.o.double(), "camera o .*torch.float64"),
            ("du", torch.zeros(4), r"camera du .*\(4,\)"),
            ("dv", torch.zeros((3, 2))[:, 0], "camera dv .*not contiguous"),
            ("corner", torch.zeros(3, device="meta"), "camera corner .*on "
                                                      "cpu, got .* on meta")):
        bent = dataclasses.replace(
            sc, camera=dataclasses.replace(cam, **{field: bad}))
        with pytest.raises(ValueError, match=why):
            bdpt_cuda.t1_splats_cuda(bent, CFG, ys, zs)


@pytest.mark.parametrize("bounces", [1, 2, 3, 4, 5, 6, 7, 8])
def test_splat_strategies_are_the_torch_loops_order(bounces):
    """The kernels' strategy list is t1_splats_plain's loop order, s = 1 ..
    V - 1 at V = max_bounces + 2, the count bdpt.splat records."""
    V = bounces + 2
    want = [(s, 1) for s in range(1, min(V, V - 1) + 1)]
    assert bdpt_cuda.splat_strategies(V, V) == want and len(want) == V - 1
    assert bdpt_cuda.splat_strategies(2, V) == [(1, 1), (2, 1)]
    assert bdpt_cuda.splat_strategies(0, V) == []
