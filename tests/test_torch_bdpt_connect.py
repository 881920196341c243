"""BDPT's connection route on the CPU (``bdpt.connection_radiance``).

CPU vertices take the torch version, ``connection_radiance_plain``, bit
for bit and without a launch; the card's wrapper
(``integrators.bdpt_cuda``) refuses CPU vertices and tensors of another
layout before it builds anything; its strategy list is the torch
version's loop order.  The kernels themselves run on the card only
(``tests/test_torch_cuda.py -k connect``).
"""

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


def vertices(name="caustic", lanes=512, cfg=CFG):
    sc = cornell_box(name, device="cpu")
    uid = torch.arange(lanes, dtype=torch.int64)
    return sc, bdpt.light_subpaths(sc, uid, cfg), bdpt.eye_subpaths(sc, uid,
                                                                     cfg)


@pytest.mark.parametrize("power", [False, True], ids=["balance", "power"])
@pytest.mark.parametrize("name", ["caustic", "spheres"])
def test_cpu_vertices_take_the_torch_route(name, power):
    """On the CPU connection_radiance is connection_radiance_plain: the
    same radiance and shadow-ray count bit for bit, no kernel launched,
    and the chunk's bdpt.connect span counts kernel 0."""
    cfg = CFG.with_(mis_power=power)
    sc, ys, zs = vertices(name, cfg=cfg)
    assert not bdpt.bdpt_on_card(sc, ys, zs)
    launches = cuda_build.LAUNCHES.copy()
    got, want = {}, {}
    L = bdpt.connection_radiance(sc, cfg, ys, zs, stats_acc=got)
    L_p = bdpt.connection_radiance_plain(sc, cfg, ys, zs, stats_acc=want)
    assert cuda_build.LAUNCHES == launches
    assert torch.equal(L, L_p) and torch.equal(got["rays_shadow"],
                                               want["rays_shadow"])
    assert float(L.sum()) > 0.0
    trace.reset()
    bdpt.trace_bdpt(sc, torch.arange(256, dtype=torch.int64), cfg)
    (rec,) = trace.records("bdpt.connect")
    assert rec.counts == {"lanes": 256, "strategies": 10, "kernel": 0}
    trace.reset()


def test_other_devices_have_no_connection_route():
    """A device that is neither the CPU nor CUDA raises, before any work."""
    sc, ys, zs = vertices(lanes=8)
    meta = [{k: torch.empty_like(x, device="meta") for k, x in v.items()}
            for v in zs]
    with pytest.raises(ValueError, match="no BDPT kernel route"):
        bdpt.bdpt_on_card(sc, ys, meta)


def test_the_wrapper_refuses_before_any_build(monkeypatch):
    """connection_radiance_cuda raises ValueError on CPU vertices, and on
    a vertex tensor that is not contiguous, not of its dtype or not of
    the chunk's length, before it builds or launches anything."""
    def no_build():
        raise AssertionError("built the kernels")

    monkeypatch.setattr(bdpt_cuda.LIB, "load", no_build)
    sc, ys, zs = vertices(lanes=64)
    with pytest.raises(ValueError, match="want CUDA vertices, got cpu"):
        bdpt_cuda.connection_radiance_cuda(sc, CFG, ys, zs)
    strided = torch.empty((64, 6))[:, :3]
    for side, vert, field, bad, why in (
            (zs, 2, "p", strided, "not contiguous"),
            (ys, 0, "ng", strided, "not contiguous"),
            (ys, 1, "pdf_rev", ys[1]["pdf_rev"].double(), "torch.float64"),
            (zs, 3, "mat", zs[3]["mat"].long(), "torch.int64"),
            (zs, 1, "delta", zs[1]["delta"][:32], r"\(32,\)")):
        kept = side[vert][field]
        side[vert][field] = bad
        try:
            with pytest.raises(ValueError, match=why):
                bdpt_cuda.connection_radiance_cuda(sc, CFG, ys, zs)
        finally:
            side[vert][field] = kept


def test_the_camera_vertex_broadcast_is_not_read():
    """The camera vertex's position and normal are stride-0 views of one
    (3,) vector; the table leaves them out (the chains never read them),
    so the walks' own tensors are taken as they are, without a copy."""
    sc, ys, zs = vertices(lanes=32)
    assert zs[0]["p"].stride() == (0, 1) and zs[0]["ng"].stride() == (0, 1)
    zs[0]["p"] = zs[0]["ng"] = None     # never looked at
    with pytest.raises(ValueError, match="want CUDA vertices"):
        bdpt_cuda.vertex_table(sc, ys, zs)


@pytest.mark.parametrize("bounces", [1, 2, 3, 4, 6, 8])
def test_strategies_are_the_torch_loops_order(bounces):
    """The kernels' strategy list is connection_radiance_plain's loop
    order, (V - 2)(V - 1) / 2 strategies at V = max_bounces + 2, the
    count bdpt.connect records."""
    V = bounces + 2
    want = [(s, t) for t in range(2, V + 1)
            for s in range(1, min(V, V - t) + 1)]
    got = bdpt_cuda.strategies(V, V, V)
    assert got == want and len(got) == (V - 2) * (V - 1) // 2
