"""tputracer_torch's bidirectional path tracer against tputracer's.

Both packages draw the same counter-based random numbers, so their
subpaths, connections and images agree up to float32 noise plus rare
decision flips.  Inputs come from np.random.default_rng(seed) or from the
path uids and go through both packages on the CPU; JAX's intersection runs
its brute force there, as the port's does.

* The camera/density helpers and _mis_weight on the same inputs (rtol 1e-6
  and 1e-5); the weight-sum-to-one identity of
  tests/golden/test_bdpt_mis_weights.py on the port's own pdf chains.
* eye_subpaths / light_subpaths per depth: prim equal on >= 99.9% of the
  lanes; on lanes with equal prim whose path has not met a sphere, p, ng,
  beta, pdf_fwd and pdf_rev at rtol 1e-4 of each value's size.  The two
  packages round the sphere quadratic apart (ROADMAP C, spheres), so a vertex
  ON a sphere is held to 1e-4 of |p| plus 4x the quadratic's float32
  rounding bound (ng to that over the radius), and the pdfs of every
  vertex after one (cosines near grazing amplify the shift) to rtol 1e-3.
* trace_bdpt and render_bdpt at the golden tolerances of
  tests/golden/test_pt_vs_oracle.py (mean rel < 5e-4, outlier share < 1%),
  ray counts and splat energy at rtol 1e-3.  On the CPU index_add_ adds in
  order; on the card it adds in no fixed order, so the card tests hold the
  splat at float tolerance and L_own bit for bit.
* The JAX frames stored for the card's kernel route
  (tests/golden/bdpt_jax_frames.py) against a fresh JAX render, at the
  same tolerances.
* The port alone: chunk invariance, a t=1 splat from a vertex almost in
  the camera's plane (no cast may wrap onto the film), and BDPT against
  the port's own PT on the caustics scene.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from golden import bdpt_jax_frames
from golden.test_bdpt_mis_weights import _build_vertex_lists, _make_paths
from test_torch_intersect import sphere_t_bound
from test_torch_pt import golden_compare
from tputracer.api import render_bdpt as jax_render_bdpt
from tputracer.config import BdptConfig as JaxBdptConfig
from tputracer.integrators import bdpt as jb
from tputracer.scene import cornell_box as jax_cornell_box
from tputracer_torch import geometry as g
from tputracer_torch.api import render, render_bdpt
from tputracer_torch.bsdf import pdf_bsdf
from tputracer_torch.config import BdptConfig, RenderConfig
from tputracer_torch.integrators import bdpt as tb
from tputracer_torch.scene import cornell_box
from tputracer_torch.scene.types import DIFFUSE

FIELDS = ("p", "ng", "wo", "beta", "pdf_fwd", "pdf_rev", "mat", "prim",
          "delta", "valid")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)


def unit(r, n):
    v = r.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("helper", ["convert_density", "camera_forward",
                                    "camera_area", "camera_pdf_sa"])
def test_camera_and_density_helpers_match_jax(helper):
    js, ts = jax_cornell_box("caustic"), cornell_box("caustic", device="cpu")
    r = np.random.default_rng(17)
    n = 4096
    if helper == "convert_density":
        args = (r.uniform(0.01, 2.0, n).astype(np.float32),
                r.uniform(0.0, 1.0, (n, 3)).astype(np.float32),
                r.uniform(0.0, 1.0, (n, 3)).astype(np.float32), unit(r, n))
        # keep |n_to . w| at least half of |w|: XLA may sum the dot in
        # another order than the port's x + y + z, or with FMAs (jax.jit of
        # the same function does), which moves it by up to 4u |w| (u =
        # 2^-24), so by 4u / 0.5 = 4.8e-7 of itself here; at the 1e-2 this
        # filter once kept, that is 2.4e-5, and 15 of 4,057 lanes of the
        # jitted reference fell outside the rtol of 1e-6
        w = args[2] - args[1]
        keep = np.abs((args[3] * w).sum(1)) > 0.5 * np.linalg.norm(w, axis=1)
        args = tuple(a[keep] for a in args)
        want = jb._convert_density(*(jnp.asarray(a) for a in args))
        got = tb._convert_density(*(torch.from_numpy(a) for a in args))
    elif helper == "camera_pdf_sa":
        # camera-like directions: the forward axis plus a random tilt
        fwd = np.asarray(jb._camera_forward(js.camera))
        d = fwd[None] + r.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
        want = jb._camera_pdf_sa(js.camera, jnp.asarray(d))
        got = tb._camera_pdf_sa(ts.camera, torch.from_numpy(d))
    else:
        want = getattr(jb, "_" + helper)(js.camera)
        got = getattr(tb, "_" + helper)(ts.camera)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def to_torch_verts(verts):
    return [{k: torch.from_numpy(np.array(v[k])) for k in FIELDS}
            for v in verts]


def strategies(k, mirror_at):
    """The samplable (s, t) of a k-vertex path, as the golden test sums
    them: t >= 1, s = k - t, s = 0 only with t >= 2, and no connection
    endpoint on the delta vertex."""
    out = []
    for t in range(1, k + 1):
        s = k - t
        if s == 0 and t < 2:
            continue
        if mirror_at is not None and s >= 1 and mirror_at in (t - 1, k - s):
            continue
        out.append((s, t))
    return out


@pytest.mark.parametrize("power", [False, True], ids=["balance", "power"])
@pytest.mark.parametrize("k", [3, 4, 5, 6])
@pytest.mark.parametrize("mirror", [False, True], ids=["diffuse", "mirror"])
def test_mis_weight_matches_jax(mirror, k, power):
    """_mis_weight on the same vertex lists (JAX's pdf chains along random
    paths through the box, as the golden weight-sum test builds them), for
    every samplable (s, t)."""
    variant = "spheres" if mirror else "boxes"
    js, ts = jax_cornell_box(variant), cornell_box(variant, device="cpu")
    mirror_at = k // 2 if mirror else None
    paths = _make_paths(js, k, 64, 40 + k, mirror_at)
    zs, ys = _build_vertex_lists(js, *paths)
    tzs, tys = to_torch_verts(zs), to_torch_verts(ys)
    for s, t in strategies(k, mirror_at):
        want = jb._mis_weight(js, js.camera, ys, zs, s, t, power=power)
        got = tb._mis_weight(ts, ts.camera, tys, tzs, s, t, power=power)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   err_msg=f"s={s} t={t}")


def vert(p, ng, wo, pdf_fwd, pdf_rev, mat, prim, delta):
    n = p.shape[0]
    return dict(p=p, ng=ng, wo=wo, beta=torch.ones((n, 3)), pdf_fwd=pdf_fwd,
                pdf_rev=pdf_rev, mat=mat, prim=prim, delta=delta,
                valid=torch.ones((n,), dtype=torch.bool))


def port_vertex_lists(scene, pts, ng, wo, mats, prims, pdf_a, e):
    """The eye (zs) and light (ys) vertex lists of the golden weight-sum
    test's _build_vertex_lists, with the port's pdf_bsdf, _camera_pdf_sa and
    _convert_density: the pdf chains _walk produces along this path."""
    pts, ng, wo, pdf_a, e = (torch.from_numpy(np.array(x))
                             for x in (pts, ng, wo, pdf_a, e))
    mats, prims = (torch.from_numpy(np.array(x)) for x in (mats, prims))
    k, n, _ = pts.shape
    zeros1 = torch.zeros((n,))
    delta = [scene.mat_kind[mats[i].long()] != DIFFUSE for i in range(k)]
    cd = tb._convert_density

    zs = [vert(pts[0], ng[0], torch.zeros((n, 3)), torch.ones((n,)), zeros1,
               torch.zeros((n,), dtype=torch.int32),
               torch.full((n,), -1, dtype=torch.int32),
               torch.zeros((n,), dtype=torch.bool))]
    for j in range(1, k):
        if j == 1:
            sa = tb._camera_pdf_sa(scene.camera, e[0])
        else:
            sa = pdf_bsdf(scene, mats[j - 1], ng[j - 1], -e[j - 2], e[j - 1])
        pf = cd(sa, pts[j - 1], pts[j], ng[j])
        pr = zeros1
        if j + 2 <= k - 1:
            pr = cd(pdf_bsdf(scene, mats[j + 1], ng[j + 1], e[j + 1], -e[j]),
                    pts[j + 1], pts[j], ng[j])
        zs.append(vert(pts[j], ng[j], wo[j], pf, pr, mats[j], prims[j],
                       delta[j]))

    pr0 = zeros1
    if k - 3 >= 0:
        pr0 = cd(pdf_bsdf(scene, mats[k - 2], ng[k - 2], -e[k - 3], e[k - 2]),
                 pts[k - 2], pts[k - 1], ng[k - 1])
    ys = [vert(pts[k - 1], ng[k - 1], torch.zeros((n, 3)), pdf_a, pr0,
               mats[k - 1], prims[k - 1], torch.zeros((n,), dtype=torch.bool))]
    for j in range(1, k - 1):
        i = k - 1 - j
        if j == 1:
            sa = torch.clamp(g.dot(ng[k - 1], -e[k - 2]), min=0.0) / np.pi
        else:
            sa = pdf_bsdf(scene, mats[i + 1], ng[i + 1], e[i + 1], -e[i])
        pf = cd(sa, pts[i + 1], pts[i], ng[i])
        pr = zeros1
        if i - 2 >= 0:
            pr = cd(pdf_bsdf(scene, mats[i - 1], ng[i - 1], -e[i - 2],
                             e[i - 1]), pts[i - 1], pts[i], ng[i])
        ys.append(vert(pts[i], ng[i], e[i], pf, pr, mats[i], prims[i],
                       delta[i]))
    return zs, ys


# the cases of tests/golden/test_bdpt_mis_weights.py's three weight-sum
# tests: all diffuse, a MIRROR vertex, and the power heuristic
WEIGHT_SUMS = ([("boxes", k, seed, None, False)
                for k, seed in ((3, 1), (4, 2), (5, 3), (6, 4))]
               + [("spheres", k, seed, m, False)
                  for k, m, seed in ((4, 1, 5), (4, 2, 6), (5, 2, 7),
                                     (5, 3, 8))]
               + [("boxes", k, seed, None, True)
                  for k, seed in ((3, 11), (4, 12), (5, 13))]
               + [("spheres", k, seed, m, True)
                  for k, m, seed in ((4, 1, 14), (5, 2, 15))])


@pytest.mark.parametrize("variant, k, seed, mirror_at, power", WEIGHT_SUMS)
def test_mis_weights_sum_to_one(variant, k, seed, mirror_at, power):
    """Over the samplable strategies of each path the port's weights sum to
    one, on pdf chains from the port's own pdf_bsdf."""
    js, ts = jax_cornell_box(variant), cornell_box(variant, device="cpu")
    zs, ys = port_vertex_lists(ts, *_make_paths(js, k, 64, seed, mirror_at))
    total = torch.zeros((64,))
    for s, t in strategies(k, mirror_at):
        total = total + tb._mis_weight(ts, ts.camera, ys, zs, s, t,
                                       power=power)
    np.testing.assert_allclose(total.numpy(), 1.0, rtol=2e-3)


def close_rows(got, want, tol, what):
    """|got - want| <= tol per lane, for (N,) values or (N,3) rows (the
    largest component's error); tol is (N,)."""
    err = np.abs(got.astype(np.float64) - want)
    if err.ndim == 2:
        err = err.max(axis=1)
    bad = err > tol
    assert not bad.any(), (f"{what}: {bad.sum()} lanes, e.g. {got[bad][:2]} "
                           f"vs {want[bad][:2]}")


def size(x):
    x = np.abs(x.astype(np.float64))
    return x.max(axis=1) if x.ndim == 2 else x


@pytest.mark.parametrize("variant", ["caustic", "boxes"])
def test_subpaths_match_jax(variant):
    """The eye and light walks of 4,096 uids, vertex by vertex (module
    docstring)."""
    js, ts = jax_cornell_box(variant), cornell_box(variant, device="cpu")
    kw = dict(width=16, height=16, spp=16, max_bounces=4, seed=3)
    uid = np.arange(4096)
    walks = [
        ("eye", jb.eye_subpaths(js, jnp.asarray(uid, jnp.uint32),
                                JaxBdptConfig(**kw)),
         tb.eye_subpaths(ts, torch.from_numpy(uid), BdptConfig(**kw))),
        ("light", jb.light_subpaths(js, jnp.asarray(uid, jnp.uint32),
                                    JaxBdptConfig(**kw)),
         tb.light_subpaths(ts, torch.from_numpy(uid), BdptConfig(**kw)))]
    Tp = ts.n_tri_pad
    for name, jv, tv in walks:
        assert len(jv) == len(tv) == kw["max_bounces"] + 2
        touched = np.zeros(uid.shape, bool)
        for i, (a, b) in enumerate(zip(jv, tv)):
            a = {k: np.asarray(a[k]) for k in FIELDS}
            b = {k: b[k].numpy() for k in FIELDS}
            what = f"{name} depth {i}"
            assert (a["prim"] == b["prim"]).mean() >= 0.999, what
            same = (a["prim"] == b["prim"]) & a["valid"] & b["valid"]
            on_sph = same & (a["prim"] >= Tp)
            touched |= on_sph
            for k in ("beta", "p", "ng", "pdf_fwd", "pdf_rev"):
                tol = 1e-4 * size(a[k])
                if k in ("pdf_fwd", "pdf_rev"):
                    tol = np.where(touched, 1e-3 * size(a[k]), tol)
                sel = same & ~on_sph if k in ("p", "ng") else same
                close_rows(b[k][sel], a[k][sel], tol[sel], f"{what} {k}")
            if on_sph.any():
                # the incoming ray: from the previous vertex along -wo
                prev = np.asarray(jv[i - 1]["p"])[on_sph]
                bound = 1e-4 * size(a["p"][on_sph]) + 4.0 * sphere_t_bound(
                    ts, prev, -a["wo"][on_sph], a["prim"][on_sph])
                close_rows(b["p"][on_sph], a["p"][on_sph], bound,
                           f"{what} p on a sphere")
                r = ts.sph_r.numpy()[a["prim"][on_sph] - Tp]
                close_rows(b["ng"][on_sph], a["ng"][on_sph], bound / r,
                           f"{what} ng on a sphere")
        if variant == "caustic":
            assert touched.mean() > 0.1, f"{name}: few lanes met the sphere"


def test_trace_bdpt_matches_jax():
    """One chunk of config 4's scene: per-path L_own and the splat film
    at the golden tolerances, ray counts at rtol 1e-3."""
    kw = dict(width=16, height=16, spp=4, max_bounces=4, seed=7)
    uid = np.arange(16 * 16 * 4)
    L_j, sp_j, st_j = jb.trace_bdpt(jax_cornell_box("caustic"),
                                    jnp.asarray(uid, jnp.uint32),
                                    JaxBdptConfig(**kw))
    L_t, sp_t, st_t = tb.trace_bdpt(cornell_box("caustic", device="cpu"),
                                    torch.from_numpy(uid), BdptConfig(**kw))
    assert L_t.shape == (uid.size, 3) and sp_t.shape == (16 * 16, 3)
    golden_compare(L_t.numpy(), np.asarray(L_j))
    golden_compare(sp_t.numpy(), np.asarray(sp_j))
    for k in ("rays_closest", "rays_shadow"):
        np.testing.assert_allclose(float(st_t[k]), float(st_j[k]), rtol=1e-3,
                                   err_msg=k)


RENDERS = [
    # the port in four row chunks, JAX in one: chunking changes nothing
    ("caustic", dict(width=16, height=16, spp=4, max_bounces=4, seed=5),
     16 * 4 * 4),
    ("boxes", dict(width=16, height=16, spp=4, max_bounces=4, seed=7), None),
    ("spheres", dict(width=16, height=16, spp=4, max_bounces=4, seed=9),
     None),
    ("caustic", dict(width=16, height=16, spp=4, max_bounces=4, seed=11,
                     mis_power=True), None),
]


@pytest.mark.parametrize("variant, kw, port_chunk", RENDERS,
                         ids=["caustic_chunks", "boxes", "spheres",
                              "caustic_mis_power"])
def test_render_bdpt_matches_jax(variant, kw, port_chunk):
    img_j, st_j = jax_render_bdpt(jax_cornell_box(variant),
                                  JaxBdptConfig(**kw))
    cfg = BdptConfig(**kw)
    if port_chunk:
        cfg = cfg.with_(chunk_size=port_chunk)
    img_t, st_t = render_bdpt(cornell_box(variant, device="cpu"), cfg)
    assert img_t.shape == (kw["height"], kw["width"], 3)
    assert img_t.dtype == torch.float32
    golden_compare(img_t.numpy(), np.asarray(img_j))
    for k in ("rays_closest", "rays_shadow", "splat_energy"):
        np.testing.assert_allclose(float(st_t[k]), float(st_j[k]), rtol=1e-3,
                                   err_msg=k)


@pytest.mark.parametrize("name", list(bdpt_jax_frames.FRAMES))
def test_stored_jax_frames_are_jax_renders(name):
    """The frames the card's BDPT kernel route is held to
    (tests/golden/bdpt_jax_frames.npz) are JAX's render_bdpt of their
    settings now: image at the golden tolerances, ray counts and splat
    energy at rtol 1e-3."""
    img_s, st_s = bdpt_jax_frames.stored(name)
    img_j, st_j = bdpt_jax_frames.jax_frame(name)
    assert img_s.shape == img_j.shape and img_s.dtype == np.float32
    golden_compare(img_s, img_j)
    for k in bdpt_jax_frames.STATS:
        np.testing.assert_allclose(st_s[k], st_j[k], rtol=1e-3, err_msg=k)


def test_bdpt_deterministic_and_chunk_invariant():
    """The render is a pure function of (scene, cfg), whatever the chunk
    split (port of tests/golden/test_bdpt_vs_pt.py's test)."""
    scene = cornell_box("boxes", device="cpu")
    base = BdptConfig(width=8, height=8, spp=8, max_bounces=2, seed=7,
                      chunk_size=8 * 8 * 8)
    a, _ = render_bdpt(scene, base)
    again, _ = render_bdpt(scene, base)
    b, _ = render_bdpt(scene, base.with_(chunk_size=8 * 8 * 2))
    assert torch.equal(a, again)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-7)


def test_splat_from_the_camera_plane_stays_off_the_film():
    """Light vertices almost in the camera's plane (cos_c just above the
    1e-6 in-front test) project to uu * width far beyond 2^31 at width
    4,096; the cast must not bring them back onto the film.  Only the one
    vertex in front of the camera splats, and the film is what it alone
    gives."""
    sc = cornell_box("caustic", device="cpu")
    cam = sc.camera
    cfg = BdptConfig(width=4096, height=1, spp=1, max_bounces=0)
    fwd = tb._camera_forward(cam)
    right = cam.du / torch.linalg.norm(cam.du)
    cos = torch.tensor([1.0, 1.01e-6, 1.5e-6, 1.01e-6, 2e-6, 4e-6, 1e-5,
                        5e-7, -3e-6])
    side = torch.tensor([0.0, 1, 1, -1, -1, 1, 1, 1, 1])
    sin = torch.sqrt(1.0 - cos * cos) * side
    d = cos[:, None] * fwd + sin[:, None] * right
    n = cos.shape[0]
    y = dict(p=cam.o + 0.5 * d, ng=-d, wo=torch.zeros((n, 3)),
             beta=torch.ones((n, 3)), pdf_fwd=torch.ones((n,)),
             pdf_rev=torch.zeros((n,)), mat=torch.zeros((n,), dtype=torch.int32),
             prim=torch.zeros((n,), dtype=torch.int32),
             delta=torch.zeros((n,), dtype=torch.bool),
             valid=torch.ones((n,), dtype=torch.bool))
    z = dict(p=cam.o.expand(n, 3), ng=fwd.expand(n, 3),
             wo=torch.zeros((n, 3)), beta=torch.ones((n, 3)),
             pdf_fwd=torch.ones((n,)), pdf_rev=torch.zeros((n,)),
             mat=torch.zeros((n,), dtype=torch.int32),
             prim=torch.full((n,), -1, dtype=torch.int32),
             delta=torch.zeros((n,), dtype=torch.bool),
             valid=torch.ones((n,), dtype=torch.bool))

    def clear(scene, o, d, tmax):
        return torch.zeros(o.shape[0], dtype=torch.bool)

    uu = (g.dot(d / cos.clamp(min=1e-6)[:, None] - (cam.corner - cam.o), cam.du)
          / torch.sum(cam.du * cam.du))
    assert float((uu[1:3] * cfg.width).min()) > 2.0**31
    assert float((uu[3:5] * cfg.width).max()) < -2.0**31
    splat = tb.t1_splats(sc, cfg, [y], [z], occl=clear)
    one = tb.t1_splats(sc, cfg, [{k: v[:1] for k, v in y.items()}],
                       [{k: v[:1] for k, v in z.items()}], occl=clear)
    assert int((splat.abs().sum(1) > 0).sum()) == 1 and float(one.sum()) > 0
    assert torch.equal(splat, one)


def test_bdpt_matches_pt_caustic():
    """Port of tests/golden/test_bdpt_vs_pt.py::test_bdpt_matches_pt_caustic
    on the port's own integrators: BDPT at 256 spp against PT with 5
    bounces.  The reference there takes 4,096 spp (mean rel err 0.0132 on
    the port, bound 0.018); that takes ~80 s on two CPU threads, so PT
    runs 512 spp here, whose own noise lifts the error to 0.0307: the
    bound this test holds is 0.035."""
    scene = cornell_box("caustic", device="cpu")
    ref, _ = render(scene, RenderConfig(width=12, height=12, spp=512,
                                        max_bounces=5, rr_start=99, seed=1,
                                        chunk_size=12 * 12 * 512))
    img, _ = render_bdpt(scene, BdptConfig(width=12, height=12, spp=256,
                                           max_bounces=5, seed=2,
                                           chunk_size=1 << 15))
    ref = ref.numpy()
    err = np.abs(img.numpy() - ref) / (0.05 + np.abs(ref))
    assert err.mean() < 0.035, f"bdpt vs pt mean rel err {err.mean():.4f}"
