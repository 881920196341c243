"""tputracer_torch.accel against the JAX package's intersectors.

* Brute force: the port's intersect_brute / occluded_brute against
  tputracer.accel's, on random rays (exact prim, mat, valid; t rtol 1e-6).
* The fused kernel's plain version against the Pallas kernel itself,
  tputracer.accel.intersect_tpu.intersect_fused / occluded_fused run with
  interpret=True (exact prim and booleans).
* The CUDA kernel against the plain version is tests/test_torch_cuda.py,
  which imports no JAX so that it runs on a card's machine.

Sphere t tolerance: t = -b -/+ sqrt(b^2 - c) subtracts numbers of the size
of b, and the error of b^2 - c reaches t divided by 2 sqrt(disc).  XLA on
the CPU rounds the interpreted kernel's quadratic differently from its own
brute force (the port follows the brute force bit for bit), so sphere hits
are held to 4x that float32 rounding bound, eps * ((|b| + sqrt(disc)) +
(b^2 + |oc|^2 + r^2) / sqrt(disc)), besides rtol 1e-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tputracer.accel import intersect_brute as jax_intersect_brute
from tputracer.accel import occluded_brute as jax_occluded_brute
from tputracer.accel.intersect_tpu import intersect_fused as jax_intersect_fused
from tputracer.accel.intersect_tpu import occluded_fused as jax_occluded_fused
from tputracer.scene import cornell_box as jax_cornell_box
from tputracer_torch.accel import (intersect, intersect_brute,
                                   intersect_fused, occluded, occluded_brute,
                                   occluded_fused)
from tputracer_torch.accel import intersect_cuda as ic
from tputracer_torch.scene import cornell_box
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
    plu = torch.zeros(3, T, 6)
    trin = torch.zeros(T, 3)
    v0n = torch.zeros(T)
    mask = torch.zeros(T)
    v = np.array([[0, 0, 1], [2, 0, 1], [0, 2, 1]], np.float32)
    tri_plu = torch.from_numpy(_pluecker_matrix(v[None, 0], v[None, 1],
                                                v[None, 2]))[:, :, 0]
    for j in (0, 129):
        plu[:, j] = tri_plu
        trin[j] = torch.tensor([0.0, 0.0, 4.0])
        v0n[j] = 4.0
        mask[j] = 1.0
    sph = torch.zeros(0, 4)
    t, prim = ic.fused_intersect_plain(o, d, tmin, tmax, sph, plu, trin, v0n,
                                       mask)
    assert prim.tolist() == [0, -1]
    assert t.tolist() == [2.0, 0.0]
    # a sphere touching z = 1 from the front at the same t wins the tie
    sph = torch.tensor([[0.5, 0.5, 1.5, 0.5]])
    t, prim = ic.fused_intersect_plain(o, d, tmin, tmax, sph, plu, trin, v0n,
                                       mask)
    assert prim.tolist() == [T, -1]
    assert t.tolist() == [2.0, 0.0]


def test_dispatch_on_cpu_takes_brute_force():
    ts = cornell_box("spheres", device="cpu")
    o, d, tmin, tmax, tocc = torch_args(*random_rays(500, seed=3))
    a, b = intersect(ts, o, d, tmin, tmax), intersect_brute(ts, o, d, tmin, tmax)
    assert torch.equal(a.prim, b.prim) and torch.equal(a.t, b.t)
    assert torch.equal(occluded(ts, o, d, tocc), occluded_brute(ts, o, d, tocc))


def test_cuda_wrapper_refuses_cpu_tensors():
    ts = cornell_box("boxes", device="cpu")
    o, d, tmin, tmax, _ = torch_args(*random_rays(8, seed=1))
    launches = ic.LAUNCHES
    with pytest.raises(ValueError):
        ic.fused_intersect_cuda(o, d, tmin, tmax, *ic.scene_args(ts))
    assert ic.LAUNCHES == launches
