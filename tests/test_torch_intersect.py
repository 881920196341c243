"""tputracer_torch.accel against the JAX package's intersectors.

* Brute force: the port's intersect_brute / occluded_brute against
  tputracer.accel's, on random rays (exact prim, mat, valid; t rtol 1e-6).
* The fused kernel's plain version against the Pallas kernel itself,
  tputracer.accel.intersect_tpu.intersect_fused / occluded_fused run with
  interpret=True (exact prim and booleans).
* The CUDA kernel against the plain version is tests/test_torch_cuda.py,
  which imports no JAX so that it runs on a card's machine.

Triangle t against JAX on the soups of random triangles: JAX takes v0.n
as a jnp.sum and XLA on the CPU rounds o.n its own way; t = (v0.n - o.n)
/ d.n then cancels for origins near the plane, so those hits are held to
rtol 1e-6 plus 4x the plane equation's float32 rounding bound, eps * (sum
|o_a n_a| + sum |v0_a n_a| + |t| sum |d_a n_a|) / |d.n|, as
tests/test_torch_clustered.py holds the clustered walk.  Against the
port's brute force the plain version is bit-equal.

Sphere t tolerance: t = -b -/+ sqrt(b^2 - c) subtracts numbers of the size
of b, and the error of b^2 - c reaches t divided by 2 sqrt(disc).  XLA on
the CPU rounds the interpreted kernel's quadratic differently from its own
brute force (the port follows the brute force bit for bit), so sphere hits
are held to 4x that float32 rounding bound, eps * ((|b| + sqrt(disc)) +
(b^2 + |oc|^2 + r^2) / sqrt(disc)), besides rtol 1e-6.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from chip_smoke import box_soup, holey_tables
from tputracer.accel import intersect_brute as jax_intersect_brute
from tputracer.accel import occluded_brute as jax_occluded_brute
from tputracer.accel.intersect_tpu import _fused_pallas
from tputracer.accel.intersect_tpu import intersect_fused as jax_intersect_fused
from tputracer.accel.intersect_tpu import occluded_fused as jax_occluded_fused
from tputracer.scene import cornell_box as jax_cornell_box
from tputracer.scene.types import make_scene as jax_make_scene
from tputracer_torch import cuda_build
from tputracer_torch import geometry as g
from tputracer_torch.accel import (intersect, intersect_brute,
                                   intersect_fused, occluded, occluded_brute,
                                   occluded_fused)
from tputracer_torch.accel import bruteforce as bf
from tputracer_torch.accel import intersect_cuda as ic
from tputracer_torch.scene import cornell_box, make_scene
from tputracer_torch.scene.types import _pluecker_matrix

BIG = 3.0e38


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)


def random_rays(n, seed, dead_every=4):
    """Rays from inside the box in random directions; every dead_every-th
    lane dead (tmax = 0), as the path tracer issues them."""
    r = np.random.default_rng(seed)
    o = r.uniform(0.02, 0.98, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.zeros(n, np.float32)
    tmax = np.full(n, BIG, np.float32)
    tocc = r.uniform(0.0, 1.5, n).astype(np.float32)
    if dead_every:
        tmax[::dead_every] = 0.0
        tocc[::dead_every] = 0.0
    return o, d, tmin, tmax, tocc


def torch_args(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


def jax_args(*xs):
    return tuple(jnp.asarray(x) for x in xs)


def sphere_t_bound(scene, o, d, prim):
    """Float32 rounding bound of the sphere quadratic's t, per lane."""
    s = prim - scene.n_tri_pad
    c = np.asarray(scene.sph_c)[s].astype(np.float64)
    r = np.asarray(scene.sph_r)[s].astype(np.float64)
    oc = o.astype(np.float64) - c
    b = np.sum(oc * d, axis=1)
    oo = np.sum(oc * oc, axis=1)
    sq = np.sqrt(np.maximum(b * b - oo + r * r, 0.0))
    eps = 2.0**-24
    return eps * ((np.abs(b) + sq) + (b * b + oo + r * r) / np.maximum(sq, 1e-30))


def assert_t_close(scene, o, d, prim, t_got, t_want):
    """rtol 1e-6 on triangle hits; spheres also within 4x the quadratic's
    rounding bound (module docstring)."""
    hit = prim >= 0
    tol = 1e-6 * np.abs(t_want)
    sph = prim >= scene.n_tri_pad
    tol[sph] += 4.0 * sphere_t_bound(scene, o[sph], d[sph], prim[sph])
    err = np.abs(t_got - t_want)
    bad = hit & (err > tol)
    assert not bad.any(), (
        f"{bad.sum()} t beyond tolerance, e.g. {t_got[bad][:3]} vs "
        f"{t_want[bad][:3]} at prim {prim[bad][:3]}")


def assert_plane_t_close(scene, o, d, prim, t_got, t_want):
    """Triangle hits within rtol 1e-6 plus 4x the plane equation's float32
    rounding bound (module docstring); sphere hits as assert_t_close."""
    tri = (prim >= 0) & (prim < scene.n_tri_pad)
    s = prim[tri]
    n = scene.tri_n.numpy()[s].astype(np.float64)
    v0 = scene.tri_v0.numpy()[s].astype(np.float64)
    oh, dh = o[tri].astype(np.float64), d[tri].astype(np.float64)
    t = np.abs(t_want[tri]).astype(np.float64)
    bound = 2.0**-24 * (np.abs(oh * n).sum(1) + np.abs(v0 * n).sum(1)
                        + t * np.abs(dh * n).sum(1)) / np.abs((dh * n).sum(1))
    bad = np.abs(t_got[tri] - t_want[tri]) > 1e-6 * t + 4.0 * bound
    assert not bad.any(), (
        f"{bad.sum()} t beyond tolerance, e.g. {t_got[tri][bad][:3]} vs "
        f"{t_want[tri][bad][:3]}")
    sph = prim >= scene.n_tri_pad
    assert_t_close(scene, o, d, np.where(sph, prim, -1), t_got, t_want)


@pytest.mark.parametrize("variant", ["boxes", "spheres", "glass_sphere"])
def test_brute_matches_jax(variant):
    js, ts = jax_cornell_box(variant), cornell_box(variant, device="cpu")
    o, d, tmin, tmax, tocc = random_rays(3000, seed=11)
    hj = jax_intersect_brute(js, *jax_args(o, d, tmin, tmax))
    ht = intersect_brute(ts, *torch_args(o, d, tmin, tmax))
    valid = np.asarray(hj.valid)
    np.testing.assert_array_equal(ht.valid.numpy(), valid)
    np.testing.assert_array_equal(ht.prim.numpy(), np.asarray(hj.prim))
    np.testing.assert_array_equal(ht.mat.numpy(), np.asarray(hj.mat))
    np.testing.assert_allclose(ht.t.numpy()[valid], np.asarray(hj.t)[valid],
                               rtol=1e-6)
    np.testing.assert_allclose(ht.n.numpy()[valid], np.asarray(hj.n)[valid],
                               rtol=1e-6, atol=1e-7)
    assert valid.mean() > 0.4          # the rays really hit things

    occ_j = np.asarray(jax_occluded_brute(js, *jax_args(o, d, tocc)))
    occ_t = occluded_brute(ts, *torch_args(o, d, tocc)).numpy()
    np.testing.assert_array_equal(occ_t, occ_j)


@pytest.mark.parametrize("variant", ["boxes", "spheres"])
def test_fused_plain_matches_pallas_interpret(variant):
    js, ts = jax_cornell_box(variant), cornell_box(variant, device="cpu")
    o, d, tmin, tmax, tocc = random_rays(2000, seed=23)
    hj = jax_intersect_fused(js, *jax_args(o, d, tmin, tmax), interpret=True)
    ht = intersect_fused(ts, *torch_args(o, d, tmin, tmax))   # CPU: plain
    prim = np.asarray(hj.prim)
    np.testing.assert_array_equal(ht.prim.numpy(), prim)
    np.testing.assert_array_equal(ht.valid.numpy(), np.asarray(hj.valid))
    np.testing.assert_array_equal(ht.mat.numpy(), np.asarray(hj.mat))
    # a miss reports t = tmax, as the Pallas kernel does
    np.testing.assert_array_equal(ht.t.numpy()[prim < 0], tmax[prim < 0])
    assert_t_close(ts, o, d, prim, ht.t.numpy(), np.asarray(hj.t))
    assert (prim >= 0).mean() > 0.4

    occ_j = np.asarray(jax_occluded_fused(js, *jax_args(o, d, tocc),
                                          interpret=True))
    occ_t = occluded_fused(ts, *torch_args(o, d, tocc)).numpy()
    np.testing.assert_array_equal(occ_t, occ_j)
    assert 0.2 < occ_t.mean() < 0.8


@pytest.mark.parametrize("variant", ["boxes", "spheres"])
def test_fused_plain_matches_brute(variant):
    """The two CPU backends agree: same prim, same t on triangle hits and
    within rounding on sphere hits; the any-hit booleans are equal."""
    ts = cornell_box(variant, device="cpu")
    o, d, tmin, tmax, tocc = random_rays(3000, seed=5, dead_every=3)
    hb = intersect_brute(ts, *torch_args(o, d, tmin, tmax))
    hf = intersect_fused(ts, *torch_args(o, d, tmin, tmax))
    np.testing.assert_array_equal(hf.prim.numpy(), hb.prim.numpy())
    assert_t_close(ts, o, d, hb.prim.numpy(), hf.t.numpy(), hb.t.numpy())
    np.testing.assert_array_equal(
        occluded_fused(ts, *torch_args(o, d, tocc)).numpy(),
        occluded_brute(ts, *torch_args(o, d, tocc)).numpy())


def test_fused_plain_ties_and_ragged_blocks():
    """Spheres win ties against triangles, lower triangle ids win ties
    against higher ones, and a triangle count that is not a multiple of
    the 128-triangle block is handled."""
    o = torch.tensor([[0.5, 0.5, -1.0], [0.5, 0.5, -1.0]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    tmin = torch.zeros(2)
    tmax = torch.tensor([BIG, 0.0])
    # 130 triangles: 0 and 129 are the same triangle in the plane z = 1
    T = 130
    plu = torch.zeros(3, 6, T)
    trin = torch.zeros(T, 3)
    tri_v0 = torch.zeros(T, 3)
    mask = torch.zeros(T)
    v = np.array([[0, 0, 1], [2, 0, 1], [0, 2, 1]], np.float32)
    tri_plu = torch.from_numpy(_pluecker_matrix(v[None, 0], v[None, 1],
                                                v[None, 2]))[:, :, 0]
    for j in (0, 129):
        plu[:, :, j] = tri_plu
        trin[j] = torch.tensor([0.0, 0.0, 4.0])
        tri_v0[j] = torch.from_numpy(v[0])     # v0.n = 4
        mask[j] = 1.0
    no_sph = (torch.zeros(0, 3), torch.zeros(0))
    t, prim = ic.fused_intersect_plain(o, d, tmin, tmax, *no_sph, plu, trin,
                                       tri_v0, mask)
    assert prim.tolist() == [0, -1]
    assert t.tolist() == [2.0, 0.0]
    # a sphere touching z = 1 from the front at the same t wins the tie
    sph = (torch.tensor([[0.5, 0.5, 1.5]]), torch.tensor([0.5]))
    t, prim = ic.fused_intersect_plain(o, d, tmin, tmax, *sph, plu, trin,
                                       tri_v0, mask)
    assert prim.tolist() == [T, -1]
    assert t.tolist() == [2.0, 0.0]


def brute_tables(o, d, tmin, tmax, sph_c, sph_r, plu, trin, tri_v0, mask):
    """(t, prim) of the port's brute force (accel.bruteforce) on bare
    tables in the kernel's argument order: the first minimum over the
    (N, T + S) candidate matrix, t = tmax and prim = -1 on a miss."""
    tables = SimpleNamespace(plu=plu, tri_n=trin, tri_v0=tri_v0,
                             tri_mask=mask, sph_c=sph_c, sph_r=sph_r)
    tt, tv = bf._tri_candidates(tables, o, d, tmin, tmax)
    ts, sv = bf._sph_candidates(tables, o, d, tmin, tmax)
    t_all = torch.cat([torch.where(tv, tt, BIG), torch.where(sv, ts, BIG)], 1)
    prim = torch.argmin(t_all, dim=1)
    t = torch.gather(t_all, 1, prim[:, None])[:, 0]
    hit = t < tmax
    return torch.where(hit, t, tmax), torch.where(hit, prim, -1).to(torch.int32)


def pallas_tables(o, d, tmin, tmax, sph_c, sph_r, plu, trin, tri_v0, mask):
    """(t, prim) of the Pallas kernel (interpret=True) on the same tables,
    laid out as intersect_tpu._scene_args lays them out, with v0.n in
    geometry.dot's order."""
    sph_c, sph_r, plu, trin, tri_v0, mask = (
        x.numpy() for x in (sph_c, sph_r, plu, trin, tri_v0, mask))
    S = sph_c.shape[0]
    sph = (np.concatenate([sph_c.T, sph_r[None, :]]) if S
           else np.zeros((4, 1), np.float32))
    v0n = (tri_v0[:, 0] * trin[:, 0] + tri_v0[:, 1] * trin[:, 1]
           + tri_v0[:, 2] * trin[:, 2])
    t, prim = _fused_pallas(*jax_args(o, d, tmin, tmax, sph,
                                      plu.transpose(0, 2, 1), trin,
                                      v0n[:, None], mask[:, None]),
                            n_sph=S, interpret=True)
    return np.asarray(t), np.asarray(prim)


def test_fused_plain_mask_holes_and_ties():
    """A mask with holes: the rows with mask 0 or -1 hold triangles that
    many rays would hit, and every valid triangle has an exact copy at a
    higher slot across masked slots.  The plain version skips the masked
    rows and gives every hit to the lower copy, as brute force (bit for
    bit) and the interpreted Pallas kernel (exact prim) do."""
    tables = holey_tables(seed=31, device="cpu")
    o, d, tmin, tmax, tocc = random_rays(2000, seed=41)
    rays = torch_args(o, d, tmin, tmax)
    t, prim = ic.fused_intersect_plain(*rays, *tables)
    t_b, prim_b = brute_tables(*rays, *tables)
    assert torch.equal(prim, prim_b) and torch.equal(t, t_b)
    t_j, prim_j = pallas_tables(o, d, tmin, tmax, *tables)
    np.testing.assert_array_equal(prim.numpy(), prim_j)
    hit = prim.numpy() >= 0
    np.testing.assert_allclose(t.numpy()[hit], t_j[hit], rtol=1e-6)
    np.testing.assert_array_equal(t.numpy()[~hit], tmax[~hit])
    assert hit.mean() > 0.4
    # every hit is on a valid row of the first half, never on its copy
    mask = tables[5].numpy()
    assert (mask[prim.numpy()[hit]] > 0).all()
    assert (prim.numpy()[hit] < 192).all()
    # the masked rows would be hit if the mask were ignored
    unmasked = (*tables[:5], torch.ones_like(tables[5]))
    _, prim_u = ic.fused_intersect_plain(*rays, *unmasked)
    assert float((mask[prim_u.numpy()[prim_u.numpy() >= 0]] <= 0).mean()) > 0.3
    # any hit: the same occlusion booleans as the Pallas kernel
    zeros = np.zeros_like(tocc)
    t_a, _ = ic.fused_intersect_plain(*torch_args(o, d, zeros, tocc), *tables)
    t_ja, _ = pallas_tables(o, d, zeros, tocc, *tables)
    np.testing.assert_array_equal(t_a.numpy() < tocc, t_ja < tocc)


@pytest.mark.parametrize("n_tris", [300, 2048])
def test_fused_plain_many_triangles(n_tris):
    """More than 128 valid triangles: a ragged count (300 in 384 slots),
    and 2,048, the most make_scene leaves unclustered.  The plain version
    against the interpreted Pallas kernel (exact prim, rtol 1e-6 t, equal
    occlusion) and the port's brute force (bit for bit)."""
    inputs = box_soup(n_tris, 0, seed=42)
    js, ts = jax_make_scene(*inputs), make_scene(*inputs, device="cpu")
    assert ts.n_clusters == 0 and int((ts.tri_mask > 0).sum()) == n_tris
    assert ts.n_tri_pad == -(-n_tris // 128) * 128
    o, d, tmin, tmax, tocc = random_rays(1500, seed=43)
    hj = jax_intersect_fused(js, *jax_args(o, d, tmin, tmax), interpret=True)
    ht = intersect_fused(ts, *torch_args(o, d, tmin, tmax))   # CPU: plain
    prim = np.asarray(hj.prim)
    np.testing.assert_array_equal(ht.prim.numpy(), prim)
    assert_plane_t_close(ts, o, d, prim, ht.t.numpy(), np.asarray(hj.t))
    assert (prim >= 0).mean() > 0.4
    hb = intersect_brute(ts, *torch_args(o, d, tmin, tmax))
    assert torch.equal(ht.prim, hb.prim)
    assert torch.equal(ht.t[hb.valid], hb.t[hb.valid])
    occ_j = np.asarray(jax_occluded_fused(js, *jax_args(o, d, tocc),
                                          interpret=True))
    np.testing.assert_array_equal(
        occluded_fused(ts, *torch_args(o, d, tocc)).numpy(), occ_j)


def test_fused_plain_sphere_chunks():
    """300 spheres (more than one of the kernel's 128-sphere tiles) beside
    300 triangles: the plain version against JAX's brute force and the
    port's (same prim; t within the sphere rounding bound), occlusion
    equal."""
    inputs = box_soup(300, 300, seed=44)
    js, ts = jax_make_scene(*inputs), make_scene(*inputs, device="cpu")
    o, d, tmin, tmax, tocc = random_rays(2000, seed=45)
    ht = intersect_fused(ts, *torch_args(o, d, tmin, tmax))   # CPU: plain
    for ref in (jax_intersect_brute(js, *jax_args(o, d, tmin, tmax)),
                intersect_brute(ts, *torch_args(o, d, tmin, tmax))):
        prim = np.asarray(ref.prim)
        np.testing.assert_array_equal(ht.prim.numpy(), prim)
        assert_plane_t_close(ts, o, d, prim, ht.t.numpy(), np.asarray(ref.t))
    sph = ht.prim.numpy() >= ts.n_tri_pad
    assert sph.mean() > 0.1 and (ht.prim.numpy() - ts.n_tri_pad).max() >= 128
    np.testing.assert_array_equal(
        occluded_fused(ts, *torch_args(o, d, tocc)).numpy(),
        np.asarray(jax_occluded_brute(js, *jax_args(o, d, tocc))))


def test_plane_offset_in_geometry_dot_order():
    """The kernel computes v0.n from tri_v0 and tri_n while it stages, as
    (v0x nx + v0y ny) + v0z nz with no fused multiply-add; the plain
    version takes it from geometry.dot, which must round the same way.
    The values are chosen so that other orders round differently."""
    r = np.random.default_rng(46)
    v0 = (r.normal(size=(4096, 3)) * 10.0 ** r.uniform(-3, 3, (4096, 3))
          ).astype(np.float32)
    n = (r.normal(size=(4096, 3)) * 10.0 ** r.uniform(-3, 3, (4096, 3))
         ).astype(np.float32)
    ordered = (v0[:, 0] * n[:, 0] + v0[:, 1] * n[:, 1]) + v0[:, 2] * n[:, 2]
    got = g.dot(torch.from_numpy(v0), torch.from_numpy(n)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ordered.view(np.int32))
    other = v0[:, 0] * n[:, 0] + (v0[:, 1] * n[:, 1] + v0[:, 2] * n[:, 2])
    exact = (v0.astype(np.float64) * n).sum(1).astype(np.float32)
    assert (other != ordered).any() and (exact != ordered).any()


def test_dispatch_on_cpu_takes_brute_force():
    ts = cornell_box("spheres", device="cpu")
    o, d, tmin, tmax, tocc = torch_args(*random_rays(500, seed=3))
    a, b = intersect(ts, o, d, tmin, tmax), intersect_brute(ts, o, d, tmin, tmax)
    assert torch.equal(a.prim, b.prim) and torch.equal(a.t, b.t)
    assert torch.equal(occluded(ts, o, d, tocc), occluded_brute(ts, o, d, tocc))


def test_cuda_wrapper_refuses_cpu_tensors():
    ts = cornell_box("boxes", device="cpu")
    o, d, tmin, tmax, _ = torch_args(*random_rays(8, seed=1))
    launches = cuda_build.LAUNCHES["fused_intersect_kernel"]
    with pytest.raises(ValueError):
        ic.fused_intersect_cuda(o, d, tmin, tmax, *ic.scene_args(ts))
    assert cuda_build.LAUNCHES["fused_intersect_kernel"] == launches
