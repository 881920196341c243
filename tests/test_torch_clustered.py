"""tputracer_torch.accel.clustered against the JAX package's traversals.

Scenes and rays follow tests/unit/test_accel.py (_random_scene,
_random_rays): a soup of random triangles in a cluster BVH of 16-slot
leaves, with or without two spheres.  The JAX scene is carried across with
scene_from_numpy, so both walks see the same bits.

* Against JAX's intersect_clustered / occluded_clustered (XLA): prim and
  valid exact, occlusion exact, t at rtol 1e-6 plus 4x the plane
  equation's float32 rounding bound.  JAX takes o.n and d.n as einsums,
  which XLA on the CPU rounds in its own way; t = (v0.n - o.n) / d.n then
  cancels for origins near the plane, so a last-bit difference in o.n can
  reach eps * (sum|o_a n_a| + sum|v0_a n_a| + |t| sum|d_a n_a|) / |d.n|
  (JAX's own brute force and clustered walk differ by as much).
* Against the Pallas kernel itself, intersect_pallas / occluded_pallas with
  interpret=True, at <= 600 rays as the JAX tests run it: prim exact, t at
  rtol 2e-4 (the Pallas kernel's Moeller-Trumbore against the plane
  equation here, the tolerance of tests/unit/test_accel.py), occlusion
  exact.
* Against the port's own brute force: bit-equal t and prim (the two sum
  the same products in the same order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tputracer.accel import intersect_clustered as jax_intersect_clustered
from tputracer.accel import occluded_clustered as jax_occluded_clustered
from tputracer.accel.traverse_tpu import intersect_pallas, occluded_pallas
from tputracer.scene.types import make_camera as jax_make_camera
from tputracer.scene.types import make_scene as jax_make_scene
from tputracer_torch import cuda_build
from tputracer_torch.accel import (intersect, intersect_brute,
                                   intersect_clustered, occluded,
                                   occluded_brute, occluded_clustered)
from tputracer_torch.accel import clustered as cl
from tputracer_torch.accel import traverse_cuda as tc
from tputracer_torch.accel.toptree import top_boxes
from tputracer_torch.scene import DIFFUSE, scene_from_numpy
from chip_smoke import face_rays, soup_rays
from test_torch_scene import jax_arrays

BIG = float(np.float32(3.0e38))   # the float32 value the walk returns


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)


def random_scene(n_tris=257, n_spheres=2, seed=0, leaf_size=16, size=0.25):
    """_random_scene of tests/unit/test_accel.py (triangles within +-size
    of a random point of [-1, 1]^3), built by JAX and carried across:
    (JAX scene, port scene)."""
    r = np.random.default_rng(seed)
    base = r.uniform(-1, 1, (n_tris, 1, 3))
    tv = (base + r.uniform(-size, size, (n_tris, 3, 3))).astype(np.float32)
    mats = r.integers(0, 2, n_tris).astype(np.int32)
    materials = [
        {"kind": DIFFUSE, "albedo": (0.5, 0.5, 0.5)},
        {"kind": DIFFUSE, "albedo": (0, 0, 0), "emission": (5, 5, 5)},
    ]
    spheres = [((0.2, 0.1, 0.0), 0.3, 0), ((-0.4, -0.2, 0.3), 0.2, 1)]
    cam = jax_make_camera((0, 0, -3), (0, 0, 0), (0, 1, 0), 40.0, 1.0)
    js = jax_make_scene(tv, mats, materials, spheres=spheres[:n_spheres],
                        camera=cam, accel="cluster", leaf_size=leaf_size)
    ts = scene_from_numpy(jax_arrays(js), n_tris=js.n_tris, eps=js.eps,
                          leaf_size=js.leaf_size, device="cpu")
    return js, ts


def random_rays(n, seed=1):
    r = np.random.default_rng(seed)
    o = r.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def window(case, n, seed):
    """(tmin, tmax) of one of the four cases."""
    tmin = np.zeros(n, np.float32)
    tmax = np.full(n, BIG, np.float32)
    if case == "window":
        tmin[:] = 0.8
        tmax[:] = 2.0
    elif case in ("any", "mixed"):
        r = np.random.default_rng(seed + 100)
        tmax = r.uniform(0.5, 4.0, n).astype(np.float32)
        if case == "mixed":   # a dead run and scattered dead lanes
            tmax[64:192] = 0.0
            tmax[r.integers(0, n, n // 4)] = 0.0
    return tmin, tmax


def assert_plane_t_close(scene, o, d, prim, t_got, t_want):
    """Triangle hits: rtol 1e-6 plus 4x the plane equation's rounding bound
    (module docstring).  Sphere hits: rtol 1e-6 (both packages take the
    same sphere quadratic)."""
    sph = prim >= scene.n_tri_pad
    np.testing.assert_allclose(t_got[sph], t_want[sph], rtol=1e-6)
    tri = (prim >= 0) & ~sph
    s = prim[tri]
    n = scene.tri_n.numpy()[s].astype(np.float64)
    v0 = scene.tri_v0.numpy()[s].astype(np.float64)
    oh, dh = o[tri].astype(np.float64), d[tri].astype(np.float64)
    t = np.abs(t_want[tri]).astype(np.float64)
    bound = 2.0**-24 * (np.abs(oh * n).sum(1) + np.abs(v0 * n).sum(1)
                        + t * np.abs(dh * n).sum(1)) / np.abs((dh * n).sum(1))
    err = np.abs(t_got[tri] - t_want[tri])
    bad = err > 1e-6 * t + 4.0 * bound
    assert not bad.any(), (
        f"{bad.sum()} t beyond tolerance, e.g. {t_got[tri][bad][:3]} vs "
        f"{t_want[tri][bad][:3]}")


def t_args(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


def j_args(*xs):
    return tuple(jnp.asarray(x) for x in xs)


@pytest.mark.parametrize("n_spheres", [2, 0], ids=["spheres", "no_spheres"])
@pytest.mark.parametrize("case", ["closest", "any", "window", "mixed"])
def test_clustered_matches_jax(case, n_spheres):
    n = 1001 if case == "mixed" else 512     # mixed: a ragged count
    js, ts = random_scene(n_spheres=n_spheres, seed=7)
    o, d = random_rays(n, seed=8)
    tmin, tmax = window(case, n, seed=9)
    if case == "any":
        occ_j = np.asarray(jax_occluded_clustered(js, *j_args(o, d, tmax)))
        occ_t = occluded_clustered(ts, *t_args(o, d, tmax)).numpy()
        np.testing.assert_array_equal(occ_t, occ_j)
        assert 0.05 < occ_t.mean() < 0.95
        return
    hj = jax_intersect_clustered(js, *j_args(o, d, tmin, tmax))
    ht = intersect_clustered(ts, *t_args(o, d, tmin, tmax))
    valid = np.asarray(hj.valid)
    np.testing.assert_array_equal(ht.valid.numpy(), valid)
    np.testing.assert_array_equal(ht.prim.numpy(), np.asarray(hj.prim))
    np.testing.assert_array_equal(ht.mat.numpy(), np.asarray(hj.mat))
    prim = ht.prim.numpy()
    assert_plane_t_close(ts, o, d, prim, ht.t.numpy(), np.asarray(hj.t))
    assert valid.sum() >= 30
    if case == "mixed":
        dead = tmax == 0.0
        assert not valid[dead].any()
        occ_j = np.asarray(jax_occluded_clustered(js, *j_args(o, d, tmax)))
        occ_t = occluded_clustered(ts, *t_args(o, d, tmax)).numpy()
        np.testing.assert_array_equal(occ_t, occ_j)
        assert not occ_t[dead].any()


@pytest.mark.parametrize("n_spheres", [2, 0], ids=["spheres", "no_spheres"])
def test_clustered_matches_pallas_interpret(n_spheres):
    js, ts = random_scene(n_tris=300, n_spheres=n_spheres, seed=11)
    n = 600
    o, d = random_rays(n, seed=12)
    tmin, tmax = window("closest", n, seed=13)
    tmax[64:192] = 0.0        # a dead run of lanes
    tmax[::7] = 0.0
    hj = intersect_pallas(js, *j_args(o, d, tmin, tmax), interpret=True)
    ht = intersect_clustered(ts, *t_args(o, d, tmin, tmax))
    valid = np.asarray(hj.valid)
    np.testing.assert_array_equal(ht.valid.numpy(), valid)
    np.testing.assert_array_equal(ht.prim.numpy(), np.asarray(hj.prim))
    # Moeller-Trumbore (Pallas) against the plane equation (here)
    np.testing.assert_allclose(ht.t.numpy()[valid], np.asarray(hj.t)[valid],
                               rtol=2e-4)
    assert valid.sum() >= 30
    occ_j = np.asarray(occluded_pallas(js, *j_args(o, d, tmax),
                                       interpret=True))
    occ_t = occluded_clustered(ts, *t_args(o, d, tmax)).numpy()
    np.testing.assert_array_equal(occ_t, occ_j)


@pytest.mark.parametrize("n_spheres", [2, 0], ids=["spheres", "no_spheres"])
def test_clustered_matches_brute_bitwise(n_spheres):
    _, ts = random_scene(n_tris=400, n_spheres=n_spheres, seed=21)
    n = 2000
    o, d = random_rays(n, seed=22)
    tmin, tmax = window("mixed", n, seed=23)
    hb = intersect_brute(ts, *t_args(o, d, tmin, tmax))
    hc = intersect_clustered(ts, *t_args(o, d, tmin, tmax))
    valid = hb.valid.numpy()
    assert torch.equal(hc.valid, hb.valid)
    assert torch.equal(hc.prim, hb.prim)
    assert torch.equal(hc.t[hb.valid], hb.t[hb.valid])
    # a miss reports t = tmax
    np.testing.assert_array_equal(hc.t.numpy()[~valid], tmax[~valid])
    assert torch.equal(occluded_clustered(ts, *t_args(o, d, tmax)),
                       occluded_brute(ts, *t_args(o, d, tmax)))


def hold_against_brute_and_jax(js, ts, o, d, tmin, tmax, any_hit):
    """The port's clustered walk against its brute force (bit for bit) and
    against JAX's clustered walk (prim and occlusion exact, t as in
    test_clustered_matches_jax)."""
    if any_hit:
        occ = occluded_clustered(ts, *t_args(o, d, tmax))
        assert torch.equal(occ, occluded_brute(ts, *t_args(o, d, tmax)))
        occ_j = np.asarray(jax_occluded_clustered(js, *j_args(o, d, tmax)))
        np.testing.assert_array_equal(occ.numpy(), occ_j)
        return occ.numpy()
    hc = intersect_clustered(ts, *t_args(o, d, tmin, tmax))
    hb = intersect_brute(ts, *t_args(o, d, tmin, tmax))
    assert torch.equal(hc.valid, hb.valid) and torch.equal(hc.prim, hb.prim)
    assert torch.equal(hc.t[hb.valid], hb.t[hb.valid])
    hj = jax_intersect_clustered(js, *j_args(o, d, tmin, tmax))
    np.testing.assert_array_equal(hc.valid.numpy(), np.asarray(hj.valid))
    np.testing.assert_array_equal(hc.prim.numpy(), np.asarray(hj.prim))
    assert_plane_t_close(ts, o, d, hc.prim.numpy(), hc.t.numpy(),
                         np.asarray(hj.t))
    return hc.valid.numpy()


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_walk_through_many_clusters(any_hit):
    """Rays that admit more than 32 clusters each (a soup of large
    triangles whose 16-slot cluster boxes overlap), as the kernel's lanes
    see when they refill their buffers: the walk still finds brute force's
    hit and JAX's."""
    js, ts = random_scene(n_tris=1024, n_spheres=0, seed=51, size=1.0)
    o, d, tmin, tmax, tocc = (x.numpy() for x in soup_rays(512, seed=52,
                                                            device="cpu"))
    n = o.shape[0]
    if any_hit:
        tmax = tocc
    args = cl.traverse_args(ts)
    te = cl.cluster_entries(*t_args(o, d, tmin, np.full(n, BIG, np.float32)),
                            args[0], args[1])
    assert int((te < BIG).sum(1).min()) > 32
    got = hold_against_brute_and_jax(js, ts, o, d, tmin, tmax, any_hit)
    assert 0.2 < got.mean()


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_walk_zero_entry_ties(any_hit):
    """Rays that start on a face of a cluster box and point into it enter
    that box at t = 0 * (1/d): -0 on a max face, +0 on a min face.  They
    tie at te = 0 with every box that holds the origin, and the walk
    visits the tied clusters in id order, as brute force and JAX agree."""
    js, ts = random_scene(n_tris=400, n_spheres=0, seed=61)
    cmin, cmax = cl.traverse_args(ts)[:2]
    o, d, tmin, tmax, tocc = (x.numpy() for x in face_rays(
        cmin, cmax, 600, seed=62, device="cpu"))
    if any_hit:
        tmax = tocc
    cmin, cmax = cmin.numpy(), cmax.numpy()
    # the slab terms of the faces are signed zeros, -0 and +0 both
    inv = 1.0 / d[:, None, :]
    with np.errstate(over="ignore"):   # far boxes along tiny directions
        slabs = ((cmin[None] - o[:, None]) * inv,
                 (cmax[None] - o[:, None]) * inv)
    zeros = np.concatenate([t[t == 0] for t in slabs])
    assert np.signbit(zeros).any() and not np.signbit(zeros).all()
    te = cl.cluster_entries(*t_args(o, d, tmin, tmax), *t_args(cmin, cmax))
    assert float(((te == 0).sum(1) >= 2).float().mean()) > 0.5
    got = hold_against_brute_and_jax(js, ts, o, d, tmin, tmax, any_hit)
    assert 0.1 < got.mean()


def one_triangle_clusters(boxes, leaf=5):
    """Clusters that each hold one copy of the triangle (0,0,1), (2,0,1),
    (0,2,1) in slot 2 of ``leaf`` slots, the rest padding; ``boxes`` are
    their (min, max) AABBs.  Returns the walk's scene arguments."""
    C = len(boxes)
    T = C * leaf
    v = np.array([[0, 0, 1], [2, 0, 1], [0, 2, 1]], np.float32)
    plu = torch.zeros(3, 6, T)
    trin = torch.zeros(T, 3)
    v0n = torch.zeros(T)
    mask = torch.zeros(T)
    from tputracer_torch.scene.types import _pluecker_matrix
    tri_plu = torch.from_numpy(_pluecker_matrix(v[None, 0], v[None, 1],
                                                v[None, 2]))[:, :, 0]
    for c in range(C):
        s = c * leaf + 2
        plu[:, :, s] = tri_plu
        trin[s] = torch.tensor([0.0, 0.0, 4.0])
        v0n[s] = 4.0
        mask[s] = 1.0
    cmin = torch.tensor([b[0] for b in boxes], dtype=torch.float32)
    cmax = torch.tensor([b[1] for b in boxes], dtype=torch.float32)
    return (cmin, cmax, plu, trin, v0n, mask, *top_boxes(cmin, cmax))


def test_traverse_order_and_ties():
    """Clusters are visited by (t_enter, id): equal entries in id order,
    so the lower id wins an exact tie; a nearer entry goes first whatever
    its id; the sphere preamble's bt0 wins ties; dead lanes keep
    (bt0, bp0); a leaf of 5 slots (not a multiple of 32) works."""
    leaf = 5
    o = torch.tensor([[0.5, 0.5, -1.0]] * 4)
    d = torch.tensor([[0.0, 0.0, 1.0]] * 4)
    tmin = torch.zeros(4)
    tmax = torch.tensor([BIG, BIG, 0.0, BIG])
    bt0 = torch.tensor([BIG, BIG, BIG, 2.0])    # lane 3: a sphere at t = 2
    bp0 = torch.tensor([-1, -1, -1, 99], dtype=torch.int32)
    box = ((0.0, 0.0, 0.9), (2.0, 2.0, 1.1))
    near = ((0.0, 0.0, 0.5), (2.0, 2.0, 1.1))
    # two equal boxes: cluster 0 first
    args = one_triangle_clusters([box, box], leaf)
    for any_hit in (False, True):
        t, prim = cl._traverse(o, d, tmin, tmax, bt0, bp0, *args, leaf=leaf,
                               any_hit=any_hit)
        assert prim.tolist() == [2, 2, -1, 99]
        assert t.tolist() == [2.0, 2.0, BIG, 2.0]
    # cluster 1's box is entered first
    args = one_triangle_clusters([box, near], leaf)
    t, prim = cl._traverse(o, d, tmin, tmax, bt0, bp0, *args, leaf=leaf)
    assert prim.tolist() == [leaf + 2, leaf + 2, -1, 99]
    # the CPU route of the wrapper is the plain version
    t2, prim2 = tc.traverse(o, d, tmin, tmax, bt0, bp0, *args, leaf=leaf)
    assert torch.equal(t, t2) and torch.equal(prim, prim2)


def test_cluster_entries_slab():
    """Entry distances: max(tn, tmin) inside the window, BIG outside, and
    the never-hit padding box (3e38) is never admitted, degenerate
    direction axes included."""
    cmin = torch.tensor([[0.0, 0.0, 1.0], [3.0e38] * 3])
    cmax = torch.tensor([[1.0, 1.0, 2.0], [3.0e38] * 3])
    o = torch.tensor([[0.5, 0.5, 0.0], [0.5, 0.5, 1.5], [0.5, 0.5, 0.0],
                      [0.5, 0.5, 0.0]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0], [0.0, 0.0, -1.0],
                      [1.0, 1.0, 1.0]])
    tmin = torch.tensor([0.0, 0.25, 0.0, 0.0])
    tmax = torch.tensor([BIG, BIG, BIG, BIG])
    te = cl.cluster_entries(o, d, tmin, tmax, cmin, cmax)
    assert te[:, 1].tolist() == [BIG] * 4
    assert te[0, 0].item() == 1.0
    assert te[1, 0].item() == 0.25      # inside the box: entered at tmin
    assert te[2, 0].item() == BIG       # pointing away
    assert te[3, 0].item() == BIG       # misses (x leaves before z enters)


def test_dispatch_on_cpu_takes_clustered_walk():
    _, ts = random_scene(seed=31)
    o, d = random_rays(300, seed=32)
    tmin, tmax = window("mixed", 300, seed=33)
    a = intersect(ts, *t_args(o, d, tmin, tmax))
    b = intersect_clustered(ts, *t_args(o, d, tmin, tmax))
    c = tc.intersect_traverse(ts, *t_args(o, d, tmin, tmax))
    assert torch.equal(a.prim, b.prim) and torch.equal(a.t, b.t)
    assert torch.equal(c.prim, b.prim) and torch.equal(c.t, b.t)
    occ = occluded_clustered(ts, *t_args(o, d, tmax))
    assert torch.equal(occluded(ts, *t_args(o, d, tmax)), occ)
    assert torch.equal(tc.occluded_traverse(ts, *t_args(o, d, tmax)), occ)


def test_cuda_wrapper_refuses_cpu_tensors():
    _, ts = random_scene(seed=41)
    o, d = t_args(*random_rays(8, seed=42))
    tmin, tmax = torch.zeros(8), torch.full((8,), BIG)
    bp0 = torch.full((8,), -1, dtype=torch.int32)
    launches = cuda_build.LAUNCHES["traverse_kernel"]
    with pytest.raises(ValueError):
        tc.traverse_cuda(o, d, tmin, tmax, tmax.clone(), bp0,
                         *cl.traverse_args(ts), leaf=ts.leaf_size)
    assert cuda_build.LAUNCHES["traverse_kernel"] == launches
