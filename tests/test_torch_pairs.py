"""tputracer_torch.accel.pairs against the JAX package's pair route.

Scenes and rays follow tests/unit/test_accel.py's pair tests: a soup of
480 (or 300) random triangles in 16-slot clusters, with or without two
spheres, 263 rays (a ragged count) with a dead run of 64 lanes and
scattered dead lanes.  The JAX scene is carried across with
scene_from_numpy, so both routes see the same bits.  The JAX tables are
(3,C)/(3,T); the port's (C,3)/(T,3) are handed over transposed.

* expand_plain against _expand_pallas(interpret=True): cid, te and bound
  exact (the same slab arithmetic, op for op).
* pairtest_plain against _pairtest_pallas(interpret=True), on the pairs
  JAX's own glue builds: p exact; t at rtol 1e-6 plus twice the
  Moeller-Trumbore rounding bound (pairs.rounding_bounds), because XLA on
  the CPU
  rounds the interpreted kernel's products its own way (about half the
  hits differ in the last bits; the largest difference seen was 0.19 of
  that bound).
* The route (intersect_pairs / occluded_pairs on CPU tensors) against the
  port's brute force and JAX's interpreted route: valid, prim and
  occlusion exact; t at the JAX test's rtol 2e-4 / atol 1e-6, because the
  slots test by Moeller-Trumbore while the fallback walk and the brute
  force use the plane equation.
"""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tputracer.accel import pairs_tpu as jp
from tputracer.accel.clustered import _sphere_best as jax_sphere_best
from tputracer.api import render as jax_render
from tputracer.config import RenderConfig as JaxRenderConfig
from tputracer.scene.mesh import mesh_scene as jax_mesh_scene
from tputracer_torch import accel, cli, cuda_build
from tputracer_torch.accel import clustered as cl
from tputracer_torch.accel import intersect_brute, occluded_brute
from tputracer_torch.accel import pairs as tp
from tputracer_torch.accel import pairs_cuda as pc
from tputracer_torch.config import RenderConfig
from tputracer_torch.integrators.pt import render_pt
from tputracer_torch.scene import (cornell_box, furnace, make_camera,
                                   make_scene, mesh_scene, obj_scene)
from chip_smoke import tie_pairs
from test_torch_clustered import random_rays, random_scene, t_args
from test_torch_pt import golden_compare

BIG = float(np.float32(3.0e38))
N = 4 * 64 + 7


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)


def mixed_window(n, seed):
    """tmax as the JAX pair test draws it: a dead run, scattered dead lanes."""
    r = np.random.default_rng(seed)
    tmax = r.uniform(0.5, 4.0, n).astype(np.float32)
    tmax[64:128] = 0.0
    tmax[r.integers(0, n, n // 4)] = 0.0
    return np.zeros(n, np.float32), tmax


def j_args(*xs):
    return tuple(jnp.asarray(x) for x in xs)


def jax_pairs(js, o, d, tmin, tmax):
    """What JAX's glue (pairs_tpu._pair_traverse) builds around the
    pair-test kernel: expand's (cid, te) (N,K), the stable sort by cluster
    (empty slots last) sidx, and bt0 = min(sphere best, tmax), bp0."""
    cid, te, _ = jp._expand_pallas(*j_args(o, d, tmin, tmax),
                                   js.clus_min.T, js.clus_max.T,
                                   interpret=True)
    cid, te = np.array(cid), np.array(te)
    flat = cid.reshape(-1)
    key = np.where(flat >= 0, flat, js.n_clusters + 1)
    sidx = np.argsort(key, kind="stable")
    bt0, bp0 = (np.array(x) for x in jax_sphere_best(
        js, *j_args(o, d, tmin, tmax)))
    return cid, te, sidx, np.minimum(bt0, tmax), bp0.astype(np.int32)


def jax_pairtest_folded(js, o, d, tmin, cid, te, sidx, bt0, bp0):
    """JAX's interpreted _pairtest_pallas on the sorted pairs, then JAX's
    scatter back to slot order and front-to-back fold, as
    pairs_tpu.py:259-274 write them."""
    n, k = cid.shape
    ray = sidx // k
    pt_, pp_ = jp._pairtest_pallas(
        *j_args(o[ray], d[ray], tmin[ray], cid.reshape(-1)[sidx],
                te.reshape(-1)[sidx], bt0[ray]),
        js.tri_v0.T, js.tri_e1.T, js.tri_e2.T, js.tri_mask[None, :],
        leaf=js.leaf_size, n_clusters=js.n_clusters, interpret=True)
    js_idx = jnp.asarray(sidx)
    t_slots = jnp.zeros((n * k,), jnp.float32).at[js_idx].set(pt_)
    p_slots = jnp.zeros((n * k,), jnp.int32).at[js_idx].set(pp_)
    t_slots, p_slots = t_slots.reshape(n, k), p_slots.reshape(n, k)
    best_t, best_p = jnp.asarray(bt0), jnp.asarray(bp0)
    for s in range(k):
        imp = t_slots[:, s] < best_t
        best_t = jnp.where(imp, t_slots[:, s], best_t)
        best_p = jnp.where(imp, p_slots[:, s], best_p)
    return np.asarray(best_t), np.asarray(best_p)


@pytest.mark.parametrize("case", ["closest", "mixed"])
def test_expand_plain_matches_pallas_interpret(case):
    js, ts = random_scene(n_tris=480, leaf_size=16, seed=31)
    o, d = random_rays(N, seed=32)
    tmin, tmax = mixed_window(N, seed=33)
    if case == "closest":
        tmax = np.full(N, BIG, np.float32)
    cj, tj, bj = jp._expand_pallas(*j_args(o, d, tmin, tmax),
                                   js.clus_min.T, js.clus_max.T,
                                   interpret=True)
    ct, tt, bt = tp.expand_plain(*t_args(o, d, tmin, tmax), ts.clus_min,
                                 ts.clus_max)
    assert ct.dtype == torch.int32 and ct.shape == (N, jp.K) == (N, tp.K)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    # empty slots are (-1, 3e38); dead lanes get none
    assert ((ct.numpy() >= 0) == (tt.numpy() < BIG)).all()
    assert (ct.numpy()[tmax == 0.0] == -1).all()
    # some rays admit more than K clusters: their bound is finite
    assert (bt.numpy() < BIG).mean() > 0.03


def test_expand_dead_lane_inside_a_box():
    """A dead lane (tmax = 0) whose origin sits inside a box: the walk's
    cluster_entries admits the box, expand must not give it a slot."""
    cmin = torch.tensor([[0.0, 0.0, 0.0], [2.0, 0.0, 0.0], [2.0, 0.0, 0.0]])
    cmax = torch.tensor([[1.0, 1.0, 1.0], [3.0, 1.0, 1.0], [3.0, 1.0, 1.0]])
    o = torch.tensor([[0.5, 0.5, 0.5]] * 2)
    d = torch.tensor([[1.0, 0.0, 0.0]] * 2)
    tmin = torch.zeros(2)
    tmax = torch.tensor([0.0, BIG])
    assert cl.cluster_entries(o, d, tmin, tmax, cmin, cmax)[0, 0] == 0.0
    cid, te, bound = tp.expand_plain(o, d, tmin, tmax, cmin, cmax, k=2)
    assert cid.tolist() == [[-1, -1], [0, 1]]
    assert te.tolist() == [[BIG, BIG], [0.0, 1.5]]
    # equal entries: the smaller id first; the third key is the bound
    assert bound.tolist() == [BIG, 1.5]


@pytest.mark.parametrize("n_spheres", [2, 0], ids=["spheres", "no_spheres"])
def test_pairtest_plain_matches_pallas_interpret(n_spheres):
    """The folded plain pair test against JAX's interpreted pair-test
    kernel followed by JAX's fold: prim exact; t at rtol 1e-6 plus twice
    the Moeller-Trumbore rounding bound where a slot improved on bt0, and
    bt0 itself (bit for bit) where none did."""
    js, ts = random_scene(n_tris=480, n_spheres=n_spheres, leaf_size=16,
                          seed=31)
    o, d = random_rays(N, seed=34)
    tmin, tmax = mixed_window(N, seed=35)
    tmax[tmax > 0] = BIG          # closest hits, with the dead lanes kept
    cid, te, sidx, bt0, bp0 = jax_pairs(js, o, d, tmin, tmax)
    tj, pj = jax_pairtest_folded(js, o, d, tmin, cid, te, sidx, bt0, bp0)
    tt, pt = tp.pairtest_plain(
        *t_args(o, d, tmin, bt0), torch.from_numpy(bp0),
        torch.from_numpy(sidx), torch.from_numpy(cid), torch.from_numpy(te),
        ts.tri_v0, ts.tri_e1, ts.tri_e2, ts.tri_mask, leaf=16)
    assert pt.dtype == torch.int32 and tt.shape == (N,)
    np.testing.assert_array_equal(pt.numpy(), pj)
    tri = (pj >= 0) & (pj < ts.n_tri_pad) & (tj < bt0)
    assert tri.sum() >= 20
    np.testing.assert_array_equal(tt.numpy()[~tri], tj[~tri])
    err = np.abs(tt.numpy()[tri] - tj[tri])
    _, mt = tp.rounding_bounds(ts, *t_args(o[tri], d[tri], pj[tri], tj[tri]))
    tol = 1e-6 * np.abs(tj[tri]) + 2.0 * mt.numpy()
    assert (err <= tol).all(), (err / tol).max()
    assert (pt.numpy()[tmax == 0.0] == bp0[tmax == 0.0]).all()   # dead


def test_pairtest_plain_tie_and_no_improvement():
    """chip_smoke.tie_pairs: two slots of one ray hit copies of a triangle
    at the same t (the lower slot wins), a ray whose slots never beat its
    bt0 keeps (bt0, bp0), a ray without slots, a hit in a later slot."""
    args, leaf, (want_t, want_p) = tie_pairs(device="cpu")
    t, p = tp.pairtest_plain(*args, leaf=leaf)
    assert p.tolist() == want_p and t.tolist() == want_t


def unresolved_share(ts, o, d, tmin, tmax, any_hit):
    """The live rays the K slots leave to the fallback walk."""
    o, d, tmin, tmax = t_args(o, d, tmin, tmax)
    bt0, bp0 = cl._sphere_best(ts, o, d, tmin, tmax)
    _, _, resolved = tp._slot_best(ts, o, d, tmin, tmax,
                                   torch.minimum(bt0, tmax), bp0, any_hit)
    live = (tmax > tmin).numpy()
    return 1.0 - resolved.numpy()[live].mean()


def assert_route_matches(js, ts, o, d, tmin, tmax):
    """intersect_pairs against brute force and JAX's interpreted route."""
    hb = intersect_brute(ts, *t_args(o, d, tmin, tmax))
    hj = jp.intersect_pairs(js, *j_args(o, d, tmin, tmax), interpret=True)
    ht = tp.intersect_pairs(ts, *t_args(o, d, tmin, tmax))
    v = hb.valid.numpy()
    assert v.sum() >= 20
    for want in (v, np.asarray(hj.valid)):
        np.testing.assert_array_equal(ht.valid.numpy(), want)
    for want in (hb.prim.numpy(), np.asarray(hj.prim)):
        np.testing.assert_array_equal(ht.prim.numpy()[v], want[v])
    np.testing.assert_array_equal(ht.mat.numpy()[v], hb.mat.numpy()[v])
    for want in (hb.t.numpy(), np.asarray(hj.t)):
        np.testing.assert_allclose(ht.t.numpy()[v], want[v], rtol=2e-4,
                                   atol=1e-6)
    assert not ht.valid.numpy()[tmax <= tmin].any()   # dead lanes


def assert_occlusion_matches(js, ts, o, d, tmax):
    ob = occluded_brute(ts, *t_args(o, d, tmax)).numpy()
    oj = np.asarray(jp.occluded_pairs(js, *j_args(o, d, tmax),
                                      interpret=True))
    ot = tp.occluded_pairs(ts, *t_args(o, d, tmax)).numpy()
    np.testing.assert_array_equal(ot, ob)
    np.testing.assert_array_equal(ot, oj)
    assert not ot[tmax == 0.0].any()
    assert 0.02 < ot.mean() < 0.98


@pytest.mark.parametrize("case", ["closest", "mixed"])
def test_pairs_route_matches_brute_and_jax(case):
    """Port of tests/unit/test_accel.py::
    test_pairs_kernel_matches_brute_interpret: dense overlapping clusters,
    so some rays admit more than K boxes and resolve through the fallback
    walk."""
    js, ts = random_scene(n_tris=480, leaf_size=16, seed=31)
    o, d = random_rays(N, seed=32)
    tmin, tmax = mixed_window(N, seed=33)
    if case == "closest":
        tmax = np.full(N, BIG, np.float32)
    assert_route_matches(js, ts, o, d, tmin, tmax)
    assert unresolved_share(ts, o, d, tmin, tmax, any_hit=False) > 0.0
    if case == "mixed":
        assert_occlusion_matches(js, ts, o, d, tmax)


def test_pairs_route_no_spheres():
    """Port of test_pairs_kernel_no_spheres_interpret (bt0 = tmax)."""
    js, ts = random_scene(n_tris=300, n_spheres=0, leaf_size=16, seed=41)
    o, d = random_rays(300, seed=42)
    tmin, tmax = np.zeros(300, np.float32), np.full(300, BIG, np.float32)
    assert_route_matches(js, ts, o, d, tmin, tmax)
    assert_occlusion_matches(js, ts, o, d, np.full(300, 1.5, np.float32))


def test_any_hit_overflow_goes_through_fallback():
    """Shadow rays whose K slots find nothing while a further cluster is
    entered before tmax are unresolved; the walk decides them, and the
    verdicts still equal brute force."""
    js, ts = random_scene(n_tris=480, leaf_size=16, seed=51)
    o, d = random_rays(N, seed=52)
    tmax = np.full(N, 3.5, np.float32)
    tmax[::5] = 0.0
    tmin = np.zeros(N, np.float32)
    assert unresolved_share(ts, o, d, tmin, tmax, any_hit=True) > 0.0
    assert_occlusion_matches(js, ts, o, d, tmax)


def test_pt_render_through_pairs_matches_jax():
    """PT on a clustered mesh through the pair route (plain versions on the
    CPU) against tputracer.api.render, at the golden tolerances, with
    equal per-bounce ray counts."""
    kw = dict(width=24, height=24, spp=4, max_bounces=4, rr_start=2, seed=5)
    ts = mesh_scene(subdiv=3, leaf_size=32, accel="cluster", device="cpu")
    js = jax_mesh_scene(subdiv=3, leaf_size=32, accel="cluster")
    assert ts.n_clusters > 8
    img_t, stats_t = render_pt(ts, RenderConfig(**kw),
                               intersect_fn=tp.intersect_pairs,
                               occluded_fn=tp.occluded_pairs)
    img_j, stats_j = jax_render(js, JaxRenderConfig(**kw))
    golden_compare(img_t.numpy(), np.asarray(img_j))
    for k in ("alive", "rays_closest", "rays_shadow"):
        np.testing.assert_array_equal(stats_t[k].numpy(),
                                      np.asarray(stats_j[k]), err_msg=k)


def test_dispatch_on_cpu_ignores_pairs(monkeypatch):
    """With TPUTRACER_PAIRS=1, CPU tensors still take the clustered walk."""
    monkeypatch.setenv("TPUTRACER_PAIRS", "1")
    assert accel._use_pairs()

    def refuse(*args, **kw):
        raise AssertionError("the pair route was taken on the CPU")

    monkeypatch.setattr(accel, "intersect_pairs", refuse)
    monkeypatch.setattr(accel, "occluded_pairs", refuse)
    _, ts = random_scene(seed=61)
    o, d = random_rays(300, seed=62)
    tmin, tmax = mixed_window(300, seed=63)
    a = accel.intersect(ts, *t_args(o, d, tmin, tmax))
    b = accel.intersect_clustered(ts, *t_args(o, d, tmin, tmax))
    assert torch.equal(a.prim, b.prim) and torch.equal(a.t, b.t)
    assert torch.equal(accel.occluded(ts, *t_args(o, d, tmax)),
                       accel.occluded_clustered(ts, *t_args(o, d, tmax)))
    monkeypatch.delenv("TPUTRACER_PAIRS")
    assert not accel._use_pairs()


@pytest.mark.parametrize("value", ["1", "0", "-3"])
def test_pairk_below_two_raises(monkeypatch, value):
    monkeypatch.setenv("TPUTRACER_PAIRK", value)
    with pytest.raises(ValueError):
        tp._slots()
    monkeypatch.setenv("TPUTRACER_PAIRK", "6")
    assert tp._slots() == 6
    monkeypatch.delenv("TPUTRACER_PAIRK")
    assert tp._slots() == 4 == tp.K


def test_cuda_wrappers_refuse_cpu_tensors():
    _, ts = random_scene(seed=71)
    o, d = t_args(*random_rays(8, seed=72))
    tmin, tmax = torch.zeros(8), torch.full((8,), BIG)
    cmin, cmax, v0, e1, e2, mask = tp.pairs_args(ts)
    launches = cuda_build.LAUNCHES.copy()
    with pytest.raises(ValueError):
        pc.expand_cuda(o, d, tmin, tmax, cmin, cmax, k=tp.K)
    cid = torch.zeros((8, tp.K), dtype=torch.int32)
    sidx = torch.arange(8 * tp.K)
    bp0 = torch.full((8,), -1, dtype=torch.int32)
    with pytest.raises(ValueError):
        pc.pairtest_cuda(o, d, tmin, tmax, bp0, sidx, cid, tmax[:, None]
                         .expand(8, tp.K).contiguous(), v0, e1, e2, mask,
                         leaf=ts.leaf_size)
    assert cuda_build.LAUNCHES == launches
    # the dispatchers run the plain versions on CPU tensors
    got = tp.expand(o, d, tmin, tmax, cmin, cmax)
    want = tp.expand_plain(o, d, tmin, tmax, cmin, cmax)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_entry_points_default_to_the_card():
    for fn in (cornell_box, furnace, make_camera, make_scene, mesh_scene,
               obj_scene):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert cli.parser().parse_args([]).device == "cuda"


def test_builder_without_device_raises_without_a_card():
    """No silent CPU fallback: without a card, a builder called without
    ``device`` fails as torch does."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default works there")
    with pytest.raises((AssertionError, RuntimeError)):
        cornell_box("boxes")
