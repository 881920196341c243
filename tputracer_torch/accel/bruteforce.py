"""Batched brute-force intersection, port of ``tputracer/accel/bruteforce.py``.

Every ray is tested against every primitive at once:

  * ray feature  f = [d, o x d]                    (N, 6)
  * per-edge Pluecker column  [M, E]               (6, T) x 3 edges
  * signed volumes  w[n, j, t] = sum_k f[n, k] * plu[j, k, t]   (N, 3, T)
  * hit  <=>  all three w same sign;  t from the plane equation.

The JAX package writes the volumes as a matmul at ``Precision.HIGHEST``
so that the TPU does not round them to bf16.  Here they are summed term
by term in float32, k = 0..5 in order, which no matmul precision setting
(TF32 on the card included) can change, and which rounds exactly as the
CUDA kernel does.  This is the CPU path of ``accel.intersect``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tputracer_torch import geometry as g

_BIG = 3.0e38


class Hit(NamedTuple):
    """SoA hit record over a wavefront of N rays."""

    t: torch.Tensor       # (N,)  hit distance; _BIG (brute) or tmax on miss
    prim: torch.Tensor    # (N,)  int32 primitive id (tris: [0,Tp), spheres: Tp+i); -1 miss
    valid: torch.Tensor   # (N,)  bool
    p: torch.Tensor       # (N,3) hit point
    n: torch.Tensor       # (N,3) outward unit geometric normal (by winding)
    mat: torch.Tensor     # (N,)  int32 material id (0 on miss)


def ray_features(o, d):
    """[d, o x d] as six (N,) tensors."""
    m = g.cross(o, d)
    return (d[:, 0], d[:, 1], d[:, 2], m[:, 0], m[:, 1], m[:, 2])


def edge_volume(feat, p):
    """sum_k feat[k][:, None] * p[:, k] for a (B,6) edge table -> (N,B),
    accumulated in the fixed order k = 0..5."""
    w = feat[0][:, None] * p[:, 0]
    for k in range(1, 6):
        w = w + feat[k][:, None] * p[:, k]
    return w


def _tri_candidates(scene, o, d, tmin, tmax):
    """(t, valid) per (ray, triangle): the Pluecker edge-sign test."""
    feat = ray_features(o, d)
    w0, w1, w2 = (edge_volume(feat, scene.plu[e].T) for e in range(3))
    same_sign = (((w0 >= 0.0) & (w1 >= 0.0) & (w2 >= 0.0))
                 | ((w0 <= 0.0) & (w1 <= 0.0) & (w2 <= 0.0)))   # (N,T)

    # t from the supporting plane:  t = (v0.n - o.n) / (d.n)
    nj = scene.tri_n                                  # (T,3)
    d_dot_n = (d[:, 0:1] * nj[:, 0] + d[:, 1:2] * nj[:, 1]
               + d[:, 2:3] * nj[:, 2])                # (N,T)
    o_dot_n = (o[:, 0:1] * nj[:, 0] + o[:, 1:2] * nj[:, 1]
               + o[:, 2:3] * nj[:, 2])
    v0_dot_n = g.dot(scene.tri_v0, nj)                # (T,)
    denom_ok = torch.abs(d_dot_n) > 1e-12
    t = (v0_dot_n[None, :] - o_dot_n) / torch.where(denom_ok, d_dot_n, 1.0)

    valid = (
        same_sign
        & denom_ok
        & (t > tmin[:, None])
        & (t < tmax[:, None])
        & (scene.tri_mask[None, :] > 0.0)
    )
    return t, valid


def _sph_candidates(scene, o, d, tmin, tmax):
    """(t, valid) per (ray, sphere): stable quadratic."""
    oc = o[:, None, :] - scene.sph_c[None, :, :]      # (N,S,3)
    b = g.dot(oc, d[:, None, :])                      # (N,S)
    c = g.dot(oc, oc) - scene.sph_r[None, :] ** 2
    disc = b * b - c
    ok = disc > 0.0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = -b - sq
    t1 = -b + sq
    t = torch.where(t0 > tmin[:, None], t0, t1)
    valid = ok & (t > tmin[:, None]) & (t < tmax[:, None])
    return t, valid


def intersect_brute(scene, o, d, tmin, tmax) -> Hit:
    """Closest hit over all primitives: masked argmin over the (N, T+S) t-matrix."""
    tt, tv = _tri_candidates(scene, o, d, tmin, tmax)
    t_all = torch.where(tv, tt, _BIG)
    if scene.n_spheres:
        ts, sv = _sph_candidates(scene, o, d, tmin, tmax)
        t_all = torch.cat([t_all, torch.where(sv, ts, _BIG)], dim=1)

    prim = torch.argmin(t_all, dim=1)                   # first minimum
    t = torch.gather(t_all, 1, prim[:, None])[:, 0]
    valid = t < tmax
    return finalize_hit(scene, o, d, t, prim.to(torch.int32), valid)


def finalize_hit(scene, o, d, t, prim, valid) -> Hit:
    """Assemble the Hit SoA from (t, prim, valid), shared by all
    intersectors.  Missed lanes read row 0 of the tables (their values
    are masked out downstream)."""
    Tp = scene.n_tri_pad
    is_tri = prim < Tp
    # missed lanes may carry t = _BIG; the hit POINT uses a clamped t so
    # that o + 3e38*d cannot overflow into the (masked) shading math
    p = o + torch.where(valid, t, 1.0)[:, None] * d
    tri_id = torch.where(is_tri, prim, 0).clamp(min=0).long()
    n_tri = g.normalize(scene.tri_n[tri_id])
    if scene.n_spheres:
        sph_id = torch.where(is_tri, 0, prim - Tp).long()
        n_sph = (p - scene.sph_c[sph_id]) / scene.sph_r[sph_id][:, None]
        n = torch.where(is_tri[:, None], n_tri, n_sph)
        mat = torch.where(is_tri, scene.tri_mat[tri_id],
                          scene.sph_mat[sph_id])
    else:
        n = n_tri
        mat = scene.tri_mat[tri_id]

    return Hit(
        t=t,
        prim=torch.where(valid, prim, -1),
        valid=valid,
        p=p,
        n=n,
        mat=torch.where(valid, mat, 0),
    )


def occluded_brute(scene, o, d, tmax):
    """Any-hit predicate for shadow rays: no argmin, no gathers."""
    tmin = torch.zeros_like(tmax)
    _, tv = _tri_candidates(scene, o, d, tmin, tmax)
    occ = torch.any(tv, dim=1)
    if scene.n_spheres:
        _, sv = _sph_candidates(scene, o, d, tmin, tmax)
        occ = occ | torch.any(sv, dim=1)
    return occ
