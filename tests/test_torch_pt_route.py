"""PT's kernel route on the CPU (``pt.pt_on_card``, ``integrators.pt_cuda``).

CPU calls take the torch body, ``_bounce_step_plain``, without a launch,
and their bounces count ``kernel`` 0; a call on a CUDA device takes the
kernels unless it wants a gradient, decides with a ``decision_scene`` or
injects an intersector; any other device raises.  The card's wrapper
refuses a table or uid of another dtype or shape, a scene without an
emitter and CPU tensors before it builds anything, and its argument
struct mirrors ``csrc/pt.cu``'s.  ``accel.closest``'s (t, prim) is the
closest hit of the JAX package's brute force (Cornell variants) and of
the port's brute force (a clustered mesh).  The kernels themselves run
on the card only
(``tests/test_torch_cuda.py -k pt_``).
"""

import ctypes
import dataclasses
import re
import types

import numpy as np
import pytest
import torch

from tputracer_torch import accel, cuda_build, trace
from tputracer_torch.config import RenderConfig
from tputracer_torch.integrators import pt, pt_cuda
from tputracer_torch.scene import cornell_box, mesh_scene

CFG = RenderConfig(width=16, height=16, spp=2, max_bounces=4, rr_start=2)
# a stand-in for uids on a CUDA device: the route reads only their device
CUDA_UID = types.SimpleNamespace(device=torch.device("cuda"))


@pytest.fixture(autouse=True)
def _few_threads():
    torch.set_num_threads(2)
    trace.reset()
    yield
    trace.reset()


@pytest.mark.parametrize("mis", [False, True], ids=["nee", "mis"])
@pytest.mark.parametrize("name", ["boxes", "spheres"])
def test_cpu_calls_take_the_torch_route(name, mis):
    """On the CPU render_pt runs _bounce_step_plain: no kernel launched,
    every pt.bounce.<b> span counts kernel 0, and the image is the one of
    the same render with the torch route's own intersectors injected."""
    sc = cornell_box(name, device="cpu")
    cfg = CFG.with_(mis=mis)
    uid = torch.arange(8, dtype=torch.int64)
    assert not pt.pt_on_card(sc, uid)
    launches = cuda_build.LAUNCHES.copy()
    img, st = pt.render_pt(sc, cfg)
    assert cuda_build.LAUNCHES == launches
    recs = [r for b in range(cfg.max_bounces + 1)
            for r in trace.records(f"pt.bounce.{b}")]
    assert len(recs) == cfg.max_bounces + 1
    assert all(r.counts["kernel"] == 0 for r in recs)
    img_h, st_h = pt.render_pt(sc, cfg, intersect_fn=accel.intersect,
                               occluded_fn=accel.occluded)
    assert torch.equal(img, img_h)
    assert all(st[k].dtype == torch.float32 and torch.equal(st[k], st_h[k])
               for k in st)
    assert float(img.mean()) > 0.0


def test_card_calls_take_the_kernels_unless_they_want_the_torch_route():
    """On a CUDA device the kernels take a call with no gradient wanted,
    no decision_scene and the default intersectors; a gradient call (grad
    enabled and a scene or camera tensor requiring grad), a
    decision_scene and either injected intersector take the torch
    route."""
    sc = cornell_box("spheres", device="cpu")
    assert pt.pt_on_card(sc, CUDA_UID)
    assert not pt.pt_on_card(sc, CUDA_UID, decision_scene=sc)
    assert not pt.pt_on_card(sc, CUDA_UID, intersect_fn=accel.intersect)
    assert not pt.pt_on_card(sc, CUDA_UID, occluded_fn=accel.occluded)
    for field in ("mat_albedo", "mat_emission", "mat_ior", "tri_v0"):
        graded = dataclasses.replace(
            sc, **{field: getattr(sc, field).clone().requires_grad_()})
        assert not pt.pt_on_card(graded, CUDA_UID), field
        with torch.no_grad():
            assert pt.pt_on_card(graded, CUDA_UID), field
    cam = dataclasses.replace(sc.camera, o=sc.camera.o.clone().requires_grad_())
    assert not pt.pt_on_card(dataclasses.replace(sc, camera=cam), CUDA_UID)


def test_gradient_and_decision_calls_on_the_cpu_keep_their_bits():
    """A gradient call and a decision_scene call on the CPU take the torch
    route and render the bits of the plain call."""
    sc = cornell_box("spheres", device="cpu")
    img, _ = pt.render_pt(sc, CFG)
    ior = sc.mat_ior.clone().requires_grad_()
    graded = dataclasses.replace(sc, mat_ior=ior)
    img_g, _ = pt.render_pt(graded, CFG)
    assert img_g.requires_grad
    (grad,) = torch.autograd.grad(img_g.sum(), ior)
    assert bool(torch.isfinite(grad).all())
    assert torch.equal(img_g.detach(), img)
    img_d, _ = pt.render_pt(sc, CFG, decision_scene=sc)
    assert torch.equal(img_d, img)
    recs = trace.records("pt.bounce.0")
    assert [r.counts["kernel"] for r in recs] == [0, 0, 0]


def test_other_devices_have_no_pt_route():
    """A device that is neither the CPU nor CUDA raises, before any work."""
    sc = cornell_box("boxes", device="cpu")
    meta = torch.empty(8, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no PT kernel route"):
        pt.pt_on_card(sc, meta)
    with pytest.raises(ValueError, match="no PT kernel route"):
        pt.pt_on_card(sc, meta, decision_scene=sc)


def test_the_wrapper_refuses_before_any_build(monkeypatch):
    """Wavefront raises ValueError on a uid that is not a contiguous (n,)
    int64, on a scene table of another dtype or trailing shape or not
    contiguous, on a scene without an emitter, and on CPU tensors, before
    it builds or launches anything."""
    def no_build():
        raise AssertionError("built the kernels")

    monkeypatch.setattr(pt_cuda.LIB, "load", no_build)
    sc = cornell_box("spheres", device="cpu")
    uid = torch.arange(64, dtype=torch.int64)
    with pytest.raises(ValueError, match="bounce_cuda: want CUDA tensors, "
                                         "got cpu"):
        pt_cuda.Wavefront(sc, uid, CFG)
    for bad, why in ((uid.int(), "uid .*torch.int64"),
                     (uid[::2], "uid .*not contiguous"),
                     (uid.reshape(8, 8), r"uid .*\(8, 8\)")):
        with pytest.raises(ValueError, match=why):
            pt_cuda.Wavefront(sc, bad, CFG)
    strided = torch.zeros((sc.n_tri_pad, 6))[:, :3]
    for field, bad, why in (
            ("tri_n", strided, "tri_n .*not contiguous"),
            ("mat_albedo", sc.mat_albedo.double(), "mat_albedo .*float64"),
            ("mat_kind", sc.mat_kind.long(), "mat_kind .*int64"),
            ("emit_v0", sc.emit_v0[:, :2].contiguous(), r"emit_v0 .*\(2, 2\)"),
            ("sph_mat", sc.sph_mat.to("meta"), "sph_mat .*on meta")):
        bent = dataclasses.replace(sc, **{field: bad})
        with pytest.raises(ValueError, match=why):
            pt_cuda.Wavefront(bent, uid, CFG)
    dark = dataclasses.replace(
        sc, **{f: getattr(sc, f)[:0] for f in (
            "emit_prim", "emit_area", "emit_v0", "emit_e1", "emit_e2",
            "emit_n", "emit_mat")})
    with pytest.raises(ValueError, match="no emitter"):
        pt_cuda.Wavefront(dark, uid, CFG)


def test_the_argument_struct_mirrors_the_kernels():
    """pt_cuda.Args has csrc/pt.cu's Args fields in their order, with
    their sizes, and the size the source asserts."""
    src = (cuda_build.CSRC / "pt.cu").read_text()
    body = re.search(r"struct Args \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"^\s*(?:const )?([\w ]+?)\s*(\*?)\s*(\w+);", body,
                        re.M)
    size = {"long long": 8, "int": 4, "unsigned int": 4, "float": 4}
    want = [(name, 8 if ptr else size[kind]) for kind, ptr, name in fields]
    got = [(name, ctypes.sizeof(kind)) for name, kind in pt_cuda.Args._fields_]
    assert got == want
    asserted = int(re.search(r"static_assert\(sizeof\(Args\) == (\d+)",
                             src).group(1))
    assert ctypes.sizeof(pt_cuda.Args) == asserted


def rays(n, seed, lo=-0.2, hi=1.2):
    """n rays from points in and around the unit box in random
    directions, a quarter of them dead (tmax = 0)."""
    r = np.random.default_rng(seed)
    o = r.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(r.random(n) < 0.25, 0.0, 3.0e38).astype(np.float32)
    return (torch.from_numpy(o), torch.from_numpy(d), torch.zeros(n),
            torch.from_numpy(tmax))


@pytest.mark.parametrize("name", ["boxes", "spheres", "mesh"])
def test_closest_is_the_closest_hit(name):
    """accel.closest's (t, prim) is the closest hit of an independent
    intersector: on the Cornell variants (where it is the port's brute
    force) the JAX package's intersect_brute, prim and hit lanes exact, t
    at its rtol of 1e-6 (tests/test_torch_intersect.py); on a clustered
    mesh (where it is the clustered walk) the port's brute force over
    every triangle, bit for bit on the hits.  t < tmax exactly where a ray
    hits, never on a dead lane."""
    o, d, tmin, tmax = rays(2048, seed=len(name))
    if name == "mesh":
        sc = mesh_scene(subdiv=2, accel="cluster", leaf_size=16,
                        device="cpu")
        assert sc.n_clusters > 0
        t, prim = accel.closest(sc, o, d, tmin, tmax)
        t_w, prim_w = accel.closest_brute(sc, o, d, tmin, tmax)
        valid = (t_w < tmax).numpy()
        t_w, prim_w = t_w.numpy(), prim_w.numpy()
    else:
        from jax import numpy as jnp
        from tputracer.accel import intersect_brute as jax_intersect_brute
        from tputracer.scene import cornell_box as jax_cornell_box

        sc = cornell_box(name, device="cpu")
        t, prim = accel.closest(sc, o, d, tmin, tmax)
        hj = jax_intersect_brute(jax_cornell_box(name),
                                 *(jnp.asarray(x.numpy())
                                   for x in (o, d, tmin, tmax)))
        valid = np.asarray(hj.valid)
        t_w, prim_w = np.asarray(hj.t), np.asarray(hj.prim)
    assert t.dtype == torch.float32 and prim.dtype == torch.int32
    t, prim = t.numpy(), prim.numpy()
    np.testing.assert_array_equal(t < tmax.numpy(), valid)
    np.testing.assert_array_equal(prim[valid], prim_w[valid])
    if name == "mesh":
        np.testing.assert_array_equal(t[valid], t_w[valid])
    else:
        np.testing.assert_allclose(t[valid], t_w[valid], rtol=1e-6)
    assert 0 < valid.sum() < 2048 and not valid[tmax.numpy() == 0].any()
