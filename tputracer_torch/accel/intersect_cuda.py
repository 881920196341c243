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

from tputracer_torch import geometry as g
from tputracer_torch.accel.bruteforce import (edge_volume, finalize_hit,
                                              ray_features)

_BLK = 128      # triangles per block of the plain version
_BIG = 3.0e38

# kernel launches made by this module's wrapper since the last reset
LAUNCHES = 0

_FN = None


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


def load_kernel():
    """Build (first use) and load the CUDA kernel; returns (fn, errstr)."""
    global _FN
    if _FN is None:
        from tputracer_torch.cuda_build import load_library

        lib = load_library("intersect.cu")
        fn = lib.tpt_fused_intersect
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p,        # o, d, tmin, tmax
                       p, p, i,           # sph_c, sph_r, n_sph
                       p, p, p, p, i,     # plu, trin, tri_v0, mask, n_tri
                       i, i,              # n_rays, any_hit
                       p, p, p]           # t_out, prim_out, stream
        fn.restype = i
        lib.tpt_error_string.argtypes = [i]
        lib.tpt_error_string.restype = ctypes.c_char_p
        _FN = (fn, lib.tpt_error_string)
    return _FN


def _check(x, name, shape, dtype, device):
    if x.device != device or x.dtype != dtype or tuple(x.shape) != shape \
            or not x.is_contiguous():
        raise ValueError(
            f"{name}: want contiguous {dtype} {shape} on {device}, got "
            f"{x.dtype} {tuple(x.shape)} on {x.device}"
            f"{'' if x.is_contiguous() else ' (not contiguous)'}")


def fused_intersect_cuda(o, d, tmin, tmax, sph_c, sph_r, plu, trin, tri_v0,
                         mask, any_hit=False):
    """Launch the kernel on CUDA tensors: (t (N,) f32, prim (N,) i32).

    With any_hit the kernel stops at a ray's first hit, so t < tmax is
    right and t itself is only some hit, not the closest."""
    global LAUNCHES
    dev = o.device
    if dev.type != "cuda":
        raise ValueError(f"fused_intersect_cuda needs CUDA tensors, got {dev}")
    n, S, T = o.shape[0], sph_c.shape[0], plu.shape[2]
    f32 = torch.float32
    _check(o, "o", (n, 3), f32, dev)
    _check(d, "d", (n, 3), f32, dev)
    _check(tmin, "tmin", (n,), f32, dev)
    _check(tmax, "tmax", (n,), f32, dev)
    _check(sph_c, "sph_c", (S, 3), f32, dev)
    _check(sph_r, "sph_r", (S,), f32, dev)
    _check(plu, "plu", (3, 6, T), f32, dev)
    _check(trin, "trin", (T, 3), f32, dev)
    _check(tri_v0, "tri_v0", (T, 3), f32, dev)
    _check(mask, "mask", (T,), f32, dev)
    t = torch.empty((n,), dtype=f32, device=dev)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return t, prim
    fn, errstr = load_kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(o.data_ptr(), d.data_ptr(), tmin.data_ptr(), tmax.data_ptr(),
                 sph_c.data_ptr(), sph_r.data_ptr(), S, plu.data_ptr(),
                 trin.data_ptr(), tri_v0.data_ptr(), mask.data_ptr(), T, n,
                 int(any_hit), t.data_ptr(), prim.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"tpt_fused_intersect launch failed: "
                           f"{errstr(err).decode()} ({err})")
    LAUNCHES += 1
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


def intersect_fused(scene, o, d, tmin, tmax):
    """Closest hit over all primitives (Hit SoA)."""
    t, prim = fused_intersect(*_rays(o, d, tmin, tmax), *scene_args(scene))
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
