"""Fused small-scene intersection: the CUDA kernel and its plain version.

Port of ``tputracer/accel/intersect_tpu.py``.  For each ray, the closest
hit over every analytic sphere and every padded triangle with
tmin < t < tmax, as ``(t, prim)``:

  * spheres first (stable quadratic: near root if above tmin, else far);
  * triangles by Pluecker edge signs, t from the plane equation, rows
    with tri_mask == 0 skipped;
  * a candidate replaces the best only with a strictly smaller t, so a
    sphere beats a triangle at equal t and a lower triangle index beats a
    higher one;
  * prim = T_pad + s for sphere s, -1 on a miss, and t = tmax on a miss
    (callers test ``t < tmax``).

On a CUDA tensor the wrappers launch ``csrc/intersect.cu`` (built at first
use); on a CPU tensor they run :func:`fused_intersect_plain`, a torch
transcription of the same semantics.  There is no other route.  Both read
the scene's own tables (:func:`scene_args`), so a call copies none; v0.n
is computed from tri_v0 and tri_n in geometry.dot's order.
Intersection is detached: (t, prim) depend on geometry only, never on the
differentiable material and light tables.
"""

from __future__ import annotations

import ctypes

import torch

from tputracer_torch import cuda_build
from tputracer_torch import geometry as g
from tputracer_torch.accel.bruteforce import (edge_volume, finalize_hit,
                                              ray_features)
from tputracer_torch.cuda_build import Library, check

_BLK = 128      # triangles per block of the plain version
_BIG = 3.0e38

_p, _i = ctypes.c_void_p, ctypes.c_int
LIB = Library("intersect.cu", "tpt_error_string", {
    "tpt_fused_intersect": ([_p, _p, _p, _p,       # o, d, tmin, tmax
                             _p, _p, _i,           # sph_c, sph_r, n_sph
                             _p, _p, _p, _p, _i,   # plu, trin, tri_v0, mask,
                                                   # n_tri
                             _i, _i,               # n_rays, any_hit
                             _p, _p],              # t_out, prim_out
                            ["fused_intersect_kernel"])})


def __getattr__(name):
    if name == "LAUNCHES":   # read by the benchmark (perfbench/program.py)
        return cuda_build.LAUNCHES["fused_intersect_kernel"]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def scene_args(scene):
    """The scene's own tables, in the order the kernel takes them: sph_c
    (S,3), sph_r (S,), plu (3,6,T), tri_n (T,3), tri_v0 (T,3), tri_mask
    (T,).  Detached views: no copy, no arithmetic, no kernel."""
    return tuple(x.detach() for x in (scene.sph_c, scene.sph_r, scene.plu,
                                      scene.tri_n, scene.tri_v0,
                                      scene.tri_mask))


def fused_intersect_plain(o, d, tmin, tmax, sph_c, sph_r, plu, trin, tri_v0,
                          mask):
    """Plain torch version of the kernel: (t (N,) f32, prim (N,) i32)."""
    T = plu.shape[2]
    ox, oy, oz = o.unbind(1)
    dx, dy, dz = d.unbind(1)
    bt = tmax
    bp = torch.full(tmax.shape, -1, dtype=torch.int32, device=o.device)
    for s in range(sph_c.shape[0]):
        cx, cy, cz = sph_c[s].unbind(0)
        r = sph_r[s]
        bx, by, bz = ox - cx, oy - cy, oz - cz
        bq = bx * dx + by * dy + bz * dz
        cq = bx * bx + by * by + bz * bz - r * r
        disc = bq * bq - cq
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t0 = -bq - sq
        t1 = -bq + sq
        ts = torch.where(t0 > tmin, t0, t1)
        ok = (disc > 0.0) & (ts > tmin) & (ts < bt)
        bt = torch.where(ok, ts, bt)
        bp = torch.where(ok, T + s, bp)

    feat = ray_features(o, d)
    v0n = g.dot(tri_v0, trin)
    for b0 in range(0, T, _BLK):
        sl = slice(b0, min(b0 + _BLK, T))
        w0, w1, w2 = (edge_volume(feat, plu[e, :, sl].T) for e in range(3))
        pos = (w0 >= 0.0) & (w1 >= 0.0) & (w2 >= 0.0)
        neg = (w0 <= 0.0) & (w1 <= 0.0) & (w2 <= 0.0)
        nx, ny, nz = trin[sl].unbind(1)
        d_dot_n = dx[:, None] * nx + dy[:, None] * ny + dz[:, None] * nz
        o_dot_n = ox[:, None] * nx + oy[:, None] * ny + oz[:, None] * nz
        ok = torch.abs(d_dot_n) > 1e-12
        t = (v0n[sl] - o_dot_n) / torch.where(ok, d_dot_n, 1.0)
        ok = (ok & (pos | neg) & (t > tmin[:, None]) & (t < bt[:, None])
              & (mask[sl] > 0.0))
        tblk = torch.where(ok, t, _BIG)
        j = torch.argmin(tblk, dim=1)                  # first minimum
        th = torch.gather(tblk, 1, j[:, None])[:, 0]
        imp = th < bt
        bt = torch.where(imp, th, bt)
        bp = torch.where(imp, b0 + j.to(torch.int32), bp)
    return bt, bp


def fused_intersect_cuda(o, d, tmin, tmax, sph_c, sph_r, plu, trin, tri_v0,
                         mask, any_hit=False):
    """Launch the kernel on CUDA tensors: (t (N,) f32, prim (N,) i32).

    With any_hit the kernel stops at a ray's first hit, so t < tmax is
    right and t itself is only some hit, not the closest."""
    dev = o.device
    if dev.type != "cuda":
        raise ValueError(f"fused_intersect_cuda needs CUDA tensors, got {dev}")
    n, S, T = o.shape[0], sph_c.shape[0], plu.shape[2]
    f32 = torch.float32
    who = "fused_intersect_cuda"
    check(who, "o", o, f32, (n, 3), dev)
    check(who, "d", d, f32, (n, 3), dev)
    check(who, "tmin", tmin, f32, (n,), dev)
    check(who, "tmax", tmax, f32, (n,), dev)
    check(who, "sph_c", sph_c, f32, (S, 3), dev)
    check(who, "sph_r", sph_r, f32, (S,), dev)
    check(who, "plu", plu, f32, (3, 6, T), dev)
    check(who, "trin", trin, f32, (T, 3), dev)
    check(who, "tri_v0", tri_v0, f32, (T, 3), dev)
    check(who, "mask", mask, f32, (T,), dev)
    t = torch.empty((n,), dtype=f32, device=dev)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        LIB.launch("tpt_fused_intersect", dev, o, d, tmin, tmax, sph_c, sph_r,
                   S, plu, trin, tri_v0, mask, T, n, int(any_hit), t, prim)
    return t, prim


def fused_intersect(o, d, tmin, tmax, sph_c, sph_r, plu, trin, tri_v0, mask,
                    any_hit=False):
    """The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    args = (o, d, tmin, tmax, sph_c, sph_r, plu, trin, tri_v0, mask)
    if o.device.type == "cuda":
        return fused_intersect_cuda(*args, any_hit=any_hit)
    if o.device.type == "cpu":
        return fused_intersect_plain(*args)
    raise ValueError(f"no intersection route for device {o.device}")


def _rays(o, d, tmin, tmax):
    return tuple(x.detach().contiguous() for x in (o, d, tmin, tmax))


def closest_fused(scene, o, d, tmin, tmax):
    """(t, prim) of the closest hit over all primitives."""
    return fused_intersect(*_rays(o, d, tmin, tmax), *scene_args(scene))


def intersect_fused(scene, o, d, tmin, tmax):
    """Closest hit over all primitives (Hit SoA)."""
    t, prim = closest_fused(scene, o, d, tmin, tmax)
    return finalize_hit(scene, o, d, t, prim, t < tmax)


def occluded_fused(scene, o, d, tmax):
    """Any-hit shadow predicate."""
    tmin = torch.zeros_like(tmax)
    t, _ = fused_intersect(*_rays(o, d, tmin, tmax), *scene_args(scene),
                           any_hit=True)
    return t < tmax


def intersect_plain(scene, o, d, tmin, tmax):
    """:func:`intersect_fused` through the plain version on any device —
    the reference the kernel is held to on the card."""
    t, prim = fused_intersect_plain(*_rays(o, d, tmin, tmax),
                                    *scene_args(scene))
    return finalize_hit(scene, o, d, t, prim, t < tmax)


def occluded_plain(scene, o, d, tmax):
    """:func:`occluded_fused` through the plain version on any device."""
    tmin = torch.zeros_like(tmax)
    t, _ = fused_intersect_plain(*_rays(o, d, tmin, tmax),
                                 *scene_args(scene))
    return t < tmax
