"""BDPT's walk route on the CPU (``bdpt._walk``, ``bdpt.walk_on_card``).

CPU walks take the torch version, ``_walk_plain``, bit for bit and
without a launch, and the walk phases count ``kernel`` 0; gradient calls
and injected intersectors take it on the card too, where the rest goes to
``bdpt_cuda.walk_cuda`` with the walk's own arguments; another device
raises; the card's wrapper refuses CPU tensors and tensors of another
layout before it builds anything, and its argument struct mirrors
``csrc/walk.cu``'s.  The carry the kernels write in place is never a view
of another tensor (``cuda_build.owned``; camera_rays' origins), and one
rule (``scene.kernel_route``) routes the walk, PT's bounces and BDPT's
connections.  The kernel itself runs on the card only
(``tests/test_torch_cuda.py -k walk``, ``chip_smoke.py`` phase 22).
"""

import ctypes
import dataclasses
import re
import types

import pytest
import torch

from tputracer_torch import cuda_build, trace
from tputracer_torch.accel import intersect, intersect_plain
from tputracer_torch.config import BdptConfig
from tputracer_torch.integrators import bdpt, bdpt_cuda, pt
from tputracer_torch.scene import cornell_box, kernel_route

CFG = BdptConfig(width=16, height=16, spp=2, max_bounces=4)
# a CUDA device that needs no card: the route reads only uid.device
CARD = types.SimpleNamespace(device=torch.device("cuda"))


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def walk_start(sc, lanes):
    """The light walk's arguments for ``lanes`` paths, as light_subpaths
    makes them, with y0 (positional: scene, o, d, beta, pdf_sa, uid, cfg,
    n_verts, slot, origin, transport_radiance; keyword: start_p)."""
    uid = torch.arange(lanes, dtype=torch.int64)
    ys = bdpt.light_subpaths(sc, uid, CFG)
    y0 = dict(ys[0], pdf_rev=torch.zeros(lanes))
    n_l, yp = y0["ng"], y0["p"]
    d0 = torch.nn.functional.normalize(n_l + 0.25, dim=-1)
    pdf = torch.full((lanes,), 0.3)
    args = (sc, yp + n_l * sc.eps, d0, y0["beta"] * 3.0, pdf, uid, CFG,
            CFG.max_bounces + 1, 6, y0, False)
    return args, dict(start_p=yp)


@pytest.mark.parametrize("power", [False, True], ids=["balance", "power"])
@pytest.mark.parametrize("name", ["caustic", "spheres"])
def test_cpu_walks_take_the_torch_route(name, power, monkeypatch):
    """On the CPU both walks are _walk_plain's: the same vertices and ray
    count bit for bit as through the plain intersector's hook, no kernel
    launched, the card's wrapper never called, and the chunk's walk
    phases count kernel 0."""
    def no_kernel(*args, **kwargs):
        raise AssertionError("took the card's walk")

    monkeypatch.setattr(bdpt_cuda, "walk_cuda", no_kernel)
    cfg = CFG.with_(mis_power=power)
    sc = cornell_box(name, device="cpu")
    uid = torch.arange(512, dtype=torch.int64)
    assert not bdpt.walk_on_card(sc, uid)
    launches = cuda_build.LAUNCHES.copy()
    for subpaths in (bdpt.eye_subpaths, bdpt.light_subpaths):
        got, want = {}, {}
        vs = subpaths(sc, uid, cfg, stats_acc=got)
        ps = subpaths(sc, uid, cfg, isect=intersect_plain, stats_acc=want)
        assert len(vs) == len(ps) == cfg.max_bounces + 2
        for v, p in zip(vs, ps):
            assert v.keys() == p.keys()
            assert all(torch.equal(v[k], p[k]) for k in p)
        assert torch.equal(got["rays_closest"], want["rays_closest"])
        assert float(got["rays_closest"]) > 512
    assert cuda_build.LAUNCHES == launches
    trace.reset()
    bdpt.trace_bdpt(sc, torch.arange(256, dtype=torch.int64), cfg)
    for walk in ("bdpt.eye_walk", "bdpt.light_walk"):
        (rec,) = trace.records(walk)
        assert rec.counts == {"lanes": 256, "verts": 6, "kernel": 0}
    trace.reset()


def test_the_route_on_the_card():
    """On a CUDA device the walk takes the kernel unless an intersector is
    injected or a gradient is wanted (grad enabled and a scene or camera
    tensor requiring grad)."""
    sc = cornell_box("caustic", device="cpu")
    assert bdpt.walk_on_card(sc, CARD)
    assert not bdpt.walk_on_card(sc, CARD, isect=intersect)
    for field in ("mat_albedo", "mat_emission"):
        bent = dataclasses.replace(
            sc, **{field: getattr(sc, field).clone().requires_grad_()})
        assert not bdpt.walk_on_card(bent, CARD)
        with torch.no_grad():
            assert bdpt.walk_on_card(bent, CARD)
    cam = dataclasses.replace(sc.camera,
                              o=sc.camera.o.clone().requires_grad_())
    assert not bdpt.walk_on_card(dataclasses.replace(sc, camera=cam), CARD)


def test_the_card_route_gets_the_walks_arguments(monkeypatch):
    """Where walk_on_card holds, _walk hands walk_cuda its arguments as
    they are, without the intersector, and returns its vertices."""
    calls = []

    def fake(*args, **kwargs):
        calls.append((args, kwargs))
        return ["vertices"]

    sc = cornell_box("caustic", device="cpu")
    args, kwargs = walk_start(sc, 64)
    monkeypatch.setattr(bdpt, "walk_on_card", lambda sc, uid, isect: True)
    monkeypatch.setattr(bdpt_cuda, "walk_cuda", fake)
    acc = {}
    assert bdpt._walk(*args, **kwargs, stats_acc=acc) == ["vertices"]
    ((got, got_kw),) = calls
    assert all(g is a for g, a in zip(got, args)) and len(got) == len(args)
    assert got_kw == dict(start_p=kwargs["start_p"], stats_acc=acc)


def test_other_devices_have_no_walk_route():
    """A device that is neither the CPU nor CUDA raises, before any
    work."""
    sc = cornell_box("caustic", device="cpu")
    meta = torch.arange(8, device="meta")
    with pytest.raises(ValueError, match="no BDPT walk route"):
        bdpt.walk_on_card(sc, meta)


@pytest.mark.parametrize("lanes", [1, 7])
def test_camera_origins_are_their_own(lanes):
    """camera_rays' origins are the camera's, in memory of their own: a
    chunk of one lane, whose broadcast would be a contiguous (1, 3) view
    of the camera's origin, included."""
    sc = cornell_box("caustic", device="cpu")
    uid = torch.arange(lanes, dtype=torch.int64)
    o, _ = pt.camera_rays(sc, uid, CFG)
    assert o.is_contiguous() and o._base is None
    assert (o.untyped_storage().data_ptr()
            != sc.camera.o.untyped_storage().data_ptr())
    assert torch.equal(o, sc.camera.o.expand(lanes, 3))


VIEWS = {
    "one-row broadcast": lambda x: x[0][None, :].expand(1, 3),
    "row slice": lambda x: x[:2],
    "strided": lambda x: x.t(),
}


@pytest.mark.parametrize("view", list(VIEWS))
def test_owned_copies_a_view(view):
    """cuda_build.owned copies a view of another tensor, contiguous or not,
    into contiguous memory of its own, so a kernel's in-place writes leave
    the other tensor alone; a contiguous tensor that is no view it hands
    back as it is."""
    base = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    keep = base.clone()
    v = VIEWS[view](base)
    got = cuda_build.owned(v)
    assert got.is_contiguous() and got._base is None and torch.equal(got, v)
    got.fill_(-1.0)
    assert torch.equal(base, keep)
    own = base.clone()
    assert cuda_build.owned(own) is own


def test_one_rule_routes_every_kernel():
    """scene.kernel_route: the CPU never takes the kernels, CUDA does
    unless a hook is injected or a gradient is wanted (a scene tensor or
    one of the call's tensors requiring grad, with grad enabled), and any
    other device raises naming the route; PT's, the walk's and the
    connections' predicates give its answers."""
    sc = cornell_box("caustic", device="cpu")
    cuda = CARD.device
    assert not kernel_route(sc, torch.device("cpu"), "X")
    assert kernel_route(sc, cuda, "X") and kernel_route(sc, cuda, "X", None)
    assert not kernel_route(sc, cuda, "X", None, intersect)
    graded = torch.ones(3, requires_grad=True)
    assert not kernel_route(sc, cuda, "X", tensors=[graded])
    with torch.no_grad():
        assert kernel_route(sc, cuda, "X", tensors=[graded])
    with pytest.raises(ValueError, match="no X route for device meta"):
        kernel_route(sc, torch.device("meta"), "X")
    assert pt.pt_on_card(sc, CARD) and bdpt.walk_on_card(sc, CARD)
    assert not pt.pt_on_card(sc, CARD, decision_scene=sc)
    zs = [{"beta": torch.ones((2, 3), device="meta")}]
    with pytest.raises(ValueError, match="no BDPT kernel route"):
        bdpt.bdpt_on_card(sc, [], zs)


def test_the_wrapper_refuses_before_any_build(monkeypatch):
    """walk_cuda raises ValueError on CPU tensors, and on a table, ray,
    carry or origin tensor that is not contiguous, not of its dtype or not
    of the chunk's length, and on an origin whose point is not start_p,
    before it builds or launches anything."""
    def no_build():
        raise AssertionError("built the kernel")

    monkeypatch.setattr(bdpt_cuda.WALK_LIB, "load", no_build)
    sc = cornell_box("caustic", device="cpu")
    args, kwargs = walk_start(sc, 64)
    with pytest.raises(ValueError, match="want CUDA tensors, got cpu"):
        bdpt_cuda.walk_cuda(*args, **kwargs)
    strided = torch.empty((64, 6))[:, :3]
    for k, bad, why in ((2, strided, "d .*not contiguous"),
                        (3, args[3].double(), "beta .*torch.float64"),
                        (4, args[4][:32], r"pdf_sa .*\(32,\)"),
                        (5, args[5].int(), "uid .*torch.int32")):
        with pytest.raises(ValueError, match=why):
            bdpt_cuda.walk_cuda(*args[:k], bad, *args[k + 1:], **kwargs)
    y0 = args[9]
    for field, bad, why in (("ng", strided, "origin's ng .*not contiguous"),
                            ("pdf_rev", y0["pdf_rev"].double(),
                             "origin's pdf_rev .*torch.float64")):
        bent = dict(y0, **{field: bad})
        with pytest.raises(ValueError, match=why):
            bdpt_cuda.walk_cuda(*args[:9], bent, *args[10:], **kwargs)
    with pytest.raises(ValueError, match="origin's point is not start_p"):
        bdpt_cuda.walk_cuda(*args, start_p=kwargs["start_p"].clone())
    with pytest.raises(ValueError, match=r"start_p .*\(64, 2\)"):
        bdpt_cuda.walk_cuda(*args[:9], None, *args[10:],
                            start_p=strided[:, :2].contiguous())
    for field, bad, why in (("mat_ior", sc.mat_ior.double(), "mat_ior"),
                            ("tri_mat", sc.tri_mat.long(), "tri_mat"),
                            ("sph_c", sc.sph_c[:, :2].contiguous(), "sph_c")):
        bent = dataclasses.replace(sc, **{field: bad})
        with pytest.raises(ValueError, match=why):
            bdpt_cuda.walk_cuda(bent, *args[1:], **kwargs)


def test_the_argument_struct_mirrors_the_kernel():
    """bdpt_cuda.WalkArgs has csrc/walk.cu's WalkArgs fields in their
    order, with their sizes, and the size the source asserts."""
    src = (cuda_build.CSRC / "walk.cu").read_text()
    body = re.search(r"struct WalkArgs \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"^\s*(?:const )?([\w ]+?)\s*(\*?)\s*(\w+);", body,
                        re.M)
    size = {"long long": 8, "int": 4, "unsigned int": 4, "float": 4}
    want = [(name, 8 if ptr else size[kind]) for kind, ptr, name in fields]
    got = [(name, ctypes.sizeof(kind))
           for name, kind in bdpt_cuda.WalkArgs._fields_]
    assert got == want
    asserted = int(re.search(r"static_assert\(sizeof\(WalkArgs\) == (\d+)",
                             src).group(1))
    assert ctypes.sizeof(bdpt_cuda.WalkArgs) == asserted


def test_the_walk_library_is_declared_with_its_kernel(tmp_path,
                                                     monkeypatch):
    """The walk library launches one walk_kernel a call, counted in
    cuda_build.LAUNCHES, and shares the BSDF code of csrc/shade.cuh with
    the PT kernels: an edit of the header gives both a new build key."""
    assert bdpt_cuda.WALK_LIB.kernels() == {"walk_kernel": True}
    assert cuda_build.LIBRARIES["walk.cu"] is bdpt_cuda.WALK_LIB
    for source in ("walk.cu", "pt.cu"):
        assert '#include "shade.cuh"' in (cuda_build.CSRC / source).read_text()
    for f in cuda_build.CSRC.glob("*.cu*"):
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    keys = {s: cuda_build.library_path(s) for s in ("walk.cu", "pt.cu")}
    with open(tmp_path / "shade.cuh", "a") as f:
        f.write("\n")
    assert all(cuda_build.library_path(s) != k for s, k in keys.items())
