"""BDPT on the card: the walks (``csrc/walk.cu``), the connection and
t = 1 strategies (``csrc/connect.cu``).

:func:`walk_cuda` computes what ``bdpt._walk_plain`` computes, an eye or a
light walk of a chunk, in one kernel a vertex after its closest-hit call
(``accel.closest``'s (t, prim)): ``walk_kernel`` writes the vertex's SoA
straight into its vertex tensors, the previous vertex's ``pdf_rev``, the
next vertex's throughput and the next ray, in place, and counts the
vertex's closest-hit rays.
:func:`connection_radiance_cuda` computes what
``bdpt.connection_radiance_plain`` computes, the s >= 1, t >= 2
strategies' radiance of a chunk, in two kernels around the shadow rays:
``connect_prepare_kernel`` writes every strategy's shadow ray,
contribution and candidate mask into (S, n) buffers, the caller's
``occl`` traces the S shadow-ray batches as the torch version does (one
call a strategy), and ``connect_finish_kernel`` weighs each surviving
connection by MIS and sums them.  :func:`t1_splats_cuda` computes what
``bdpt.t1_splats_plain`` computes, the t = 1 splats' film of a chunk, in
the same shape: ``splat_prepare_kernel`` projects every light vertex onto
the film, ``occl`` traces the S camera rays, and ``splat_finish_kernel``
weighs each surviving splat by MIS and adds it into the film with float
atomics.  The kernels read the walks' vertex tensors in place, through a
table of their pointers that a small kernel (``connect_table_kernel``)
fills on the device, and the camera from its tensors.

``bdpt._walk`` routes (``bdpt.walk_on_card``): uids on a CUDA device with
no gradient wanted and the default intersector come here.
``bdpt.connection_radiance`` and ``bdpt.t1_splats`` route
(``bdpt.bdpt_on_card``): vertices on a CUDA device with no gradient
wanted come here.  CPU tensors, and gradient calls, take the torch
versions, which are also the kernels' oracles.  The kernels have no
backward.  Built at first use (``cuda_build``), never at import.
"""

from __future__ import annotations

import ctypes

import torch

from tputracer_torch.cuda_build import Library, check, owned
from tputracer_torch.scene.types import CAMERA_FIELDS

# the vertex fields in the table's order (csrc/connect.cu's Field), with
# each one's dtype and trailing shape
FIELDS = {"p": (torch.float32, (3,)), "ng": (torch.float32, (3,)),
          "wo": (torch.float32, (3,)), "beta": (torch.float32, (3,)),
          "pdf_fwd": (torch.float32, ()), "pdf_rev": (torch.float32, ()),
          "mat": (torch.int32, ()), "valid": (torch.bool, ()),
          "delta": (torch.bool, ())}
# the camera vertex's position and normal, broadcast over the lanes, are
# never read: a t = 2 chain stops at the ratio of zs[1]
_UNREAD = {(0, "p"), (0, "ng")}
_WHO = "connection_radiance_cuda"
_SPLAT = "t1_splats_cuda"

_p, _i32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_TABLE = ctypes.POINTER(ctypes.c_longlong)
# each call first fills a device table with one connect_table_kernel per
# kTableChunk entries, a number that varies with the call
LIB = Library("connect.cu", "tpt_connect_error_string", {
    # host table, its entries, the device table; nz, ny, V, n; kinds,
    # albedo, eps; orig, dir, tmax, c, mask
    "tpt_connect_prepare": ([_TABLE, _i32, _p, _i32, _i32, _i32, _i64,
                             _p, _p, ctypes.c_float, _p, _p, _p, _p, _p],
                            ["connect_prepare_kernel"]),
    # host occlusion table, S, the device's, the vertex table; nz, ny, V,
    # n, power; kinds, c, mask, out
    "tpt_connect_finish": ([_TABLE, _i32, _p, _p, _i32, _i32, _i32, _i64,
                            _i32, _p, _p, _p, _p],
                           ["connect_finish_kernel"]),
    # host table, its entries, the device table; ny, V, n, width, height;
    # kinds, albedo; the camera's o, corner, du, dv, forward axis, area,
    # du2, dv2; orig, dir, tmax, c, mask, pixel
    "tpt_splat_prepare": ([_TABLE, _i32, _p, _i32, _i32, _i64, _i32, _i32,
                           _p, _p, _p, _p, _p, _p, _p, _p, _p, _p,
                           _p, _p, _p, _p, _p, _p],
                          ["splat_prepare_kernel"]),
    # host occlusion table, S, the device's, the vertex table; ny, V, n,
    # power; kinds, the camera's o, forward axis, area; c, mask, pixel,
    # film
    "tpt_splat_finish": ([_TABLE, _i32, _p, _p, _i32, _i32, _i64, _i32,
                          _p, _p, _p, _p, _p, _p, _p, _p],
                         ["splat_finish_kernel"])},
    uncounted=["connect_table_kernel"])


_BIG = 3.0e38    # bdpt._BIG: a live lane's closest-hit tmax
_WALK = "walk_cuda"
# the scene's tables the walk kernel reads, with each one's dtype and
# trailing shape; the leading dimension is the table's own
WALK_TABLES = {"tri_n": (torch.float32, (3,)), "tri_mat": (torch.int32, ()),
               "sph_c": (torch.float32, (3,)), "sph_r": (torch.float32, ()),
               "sph_mat": (torch.int32, ()), "mat_kind": (torch.int32, ()),
               "mat_albedo": (torch.float32, (3,)),
               "mat_ior": (torch.float32, ())}
# a walk vertex's fields in bdpt._walk_plain's order, each (n,) + trailing
VERTEX = {"p": (torch.float32, (3,)), "ng": (torch.float32, (3,)),
          "wo": (torch.float32, (3,)), "beta": (torch.float32, (3,)),
          "pdf_fwd": (torch.float32, ()), "pdf_rev": (torch.float32, ()),
          "mat": (torch.int32, ()), "prim": (torch.int32, ()),
          "delta": (torch.bool, ()), "valid": (torch.bool, ())}


class WalkArgs(ctypes.Structure):
    """csrc/walk.cu's ``WalkArgs``, field for field."""

    _fields_ = ([(k, ctypes.c_void_p) for k in (
        *WALK_TABLES, "uid", "hit_t", "hit_prim", "o", "d", "pdf_sa", "alive",
        "tmax", "prev_p", "prev_ng", "prev_pdf_rev", "beta", "beta_next", "p",
        "ng", "wo", "pdf_fwd", "pdf_rev", "mat", "prim", "delta", "valid",
        "count")]
        + [("n", ctypes.c_longlong)]
        + [(k, ctypes.c_int) for k in ("n_tri_pad", "last", "transport")]
        + [(k, ctypes.c_uint) for k in ("salt", "seed")]
        + [("eps", ctypes.c_float)])


WALK_LIB = Library("walk.cu", "tpt_walk_error_string", {
    "tpt_walk": ([ctypes.POINTER(WalkArgs)], ["walk_kernel"])})


def walk_cuda(scene, o, d, beta, pdf_sa, uid, cfg, n_verts, slot, origin,
              transport_radiance, start_p=None, stats_acc=None,
              closest=None):
    """``bdpt._walk_plain`` on the card: the walk's ``n_verts`` vertex
    dicts, one ``walk_kernel`` launch a vertex after ``closest``'s
    (t, prim) (default ``accel.closest``).  Every field of a valid lane is
    the torch version's bits, and so are valid, delta, pdf_fwd, pdf_rev,
    mat and prim on every lane; p, ng, wo and the next vertex's beta are
    zeros on lanes not valid at their vertex (csrc/walk.cu);
    ``origin["pdf_rev"]`` is written in place where the torch version
    replaces it.  ``o``, ``d`` and ``pdf_sa`` are the walk's carry,
    updated in place (``o`` copied first where it is a view or not
    contiguous: ``cuda_build.owned``), ``beta``
    the first vertex's throughput, and ``start_p`` (default ``o``) the
    point ``d`` leaves from, with an origin its point.
    ``stats_acc["rays_closest"]`` gains each vertex's closest-hit rays, a
    vertex at a time as the torch version adds them.  Raises ValueError,
    before any build or launch, on a tensor the kernel does not take (each
    on one device, contiguous, of its dtype and shape, and that device a
    CUDA one)."""
    from tputracer_torch import rng
    from tputracer_torch.accel import closest as closest_hit

    closest = closest_hit if closest is None else closest
    dev, n = uid.device, uid.shape[0]
    a = WalkArgs()
    for name, (dtype, tail) in WALK_TABLES.items():
        t = getattr(scene, name)
        setattr(a, name, check(_WALK, name, t, dtype, t.shape[:1] + tail, dev))
    o = owned(o)
    start_p = o if start_p is None else start_p
    a.uid = check(_WALK, "uid", uid, torch.int64, (n,), dev)
    vec, one = (n, 3), (n,)
    for name, x, shape in (("o", o, vec), ("d", d, vec), ("beta", beta, vec),
                           ("pdf_sa", pdf_sa, one), ("start_p", start_p, vec)):
        check(_WALK, name, x, torch.float32, shape, dev)
    if origin is not None:
        for name in ("p", "ng", "pdf_rev"):
            dtype, tail = VERTEX[name]
            check(_WALK, f"the origin's {name}", origin[name], dtype,
                  (n,) + tail, dev)
        if origin["p"] is not start_p:
            raise ValueError(f"{_WALK}: the origin's point is not start_p")
    if dev.type != "cuda":
        raise ValueError(f"{_WALK}: want CUDA tensors, got {dev}")
    alive = torch.ones(one, dtype=torch.bool, device=dev)
    tmin = torch.zeros(one, dtype=torch.float32, device=dev)
    tmax = torch.full(one, _BIG, dtype=torch.float32, device=dev)
    counts = torch.zeros((n_verts,), dtype=torch.int32, device=dev)
    verts = [{k: beta if (i, k) == (0, "beta") else torch.empty(
        (n,) + tail, dtype=dtype, device=dev)
        for k, (dtype, tail) in VERTEX.items()} for i in range(n_verts)]
    a.o, a.d, a.pdf_sa = o.data_ptr(), d.data_ptr(), pdf_sa.data_ptr()
    a.alive, a.tmax = alive.data_ptr(), tmax.data_ptr()
    a.n, a.n_tri_pad, a.transport = n, scene.n_tri_pad, int(
        bool(transport_radiance))
    a.seed, a.eps = int(cfg.seed) & 0xFFFFFFFF, scene.eps
    prev, prev_p = origin, start_p
    for i, v in enumerate(verts):
        t, prim = closest(scene, o, d, tmin, tmax)
        a.hit_t = check(_WALK, "t", t, torch.float32, one, dev)
        a.hit_prim = check(_WALK, "prim", prim, torch.int32, one, dev)
        a.prev_p = prev_p.data_ptr()
        a.prev_ng = None if prev is None else prev["ng"].data_ptr()
        a.prev_pdf_rev = None if prev is None else prev["pdf_rev"].data_ptr()
        a.last = int(i == n_verts - 1)
        a.beta_next = None if a.last else verts[i + 1]["beta"].data_ptr()
        for k, x in v.items():
            setattr(a, k, x.data_ptr())
        a.count = counts[i].data_ptr()
        a.salt = rng.salt(i, slot)
        WALK_LIB.launch("tpt_walk", dev, ctypes.byref(a))
        prev, prev_p = v, v["p"]
    if stats_acc is not None:
        for count in counts.to(torch.float32):
            stats_acc["rays_closest"] = (stats_acc.get("rays_closest", 0.0)
                                         + count)
    return verts


def strategies(n_eye, n_light, n_verts):
    """The (s, t) connection strategies of eye and light subpaths of
    ``n_eye`` and ``n_light`` vertices at ``n_verts`` = max_bounces + 2,
    in ``connection_radiance``'s order."""
    return [(s, t) for t in range(2, n_eye + 1)
            for s in range(1, min(n_light, n_verts - t) + 1)]


def splat_strategies(n_light, n_verts):
    """The t = 1 strategies (s, 1) of light subpaths of ``n_light``
    vertices at ``n_verts`` = max_bounces + 2, in ``t1_splats``' order."""
    return [(s, 1) for s in range(1, min(n_light, n_verts - 1) + 1)]


def vertex_table(scene, ys, zs=(), who=_WHO):
    """The pointers of the kernels' vertex table (zs, then ys, the fields
    in :data:`FIELDS`' order, 0 for a field never read; the splat's holds
    ys alone), after checking every tensor the kernels read: on one
    device, contiguous, of its dtype and shape, and that device a CUDA
    one.  Raises ValueError on anything else, before any build or
    launch."""
    dev = ys[0]["beta"].device
    n = ys[0]["beta"].shape[0]
    ptrs = []
    for v, vert in enumerate(list(zs) + list(ys)):
        for f, (dtype, tail) in FIELDS.items():
            ptrs.append(0 if zs and (v, f) in _UNREAD else check(
                who, f"vertex {v}'s {f}", vert[f], dtype, (n,) + tail, dev))
    check(who, "mat_kind", scene.mat_kind, torch.int32,
          scene.mat_kind.shape[:1], dev)
    check(who, "mat_albedo", scene.mat_albedo, torch.float32,
          (scene.mat_kind.shape[0], 3), dev)
    if dev.type != "cuda":
        raise ValueError(f"{who}: want CUDA vertices, got {dev}")
    return ptrs


def occlusion_table(occs, n, dev, who):
    """The S occlusion results' pointers, each checked an (n,) bool."""
    return [check(who, f"occlusion result {k}", o, torch.bool, (n,), dev)
            for k, o in enumerate(occs)]


def connection_radiance_cuda(scene, cfg, ys, zs, occl=None, stats_acc=None):
    """``bdpt.connection_radiance_plain`` on the card: the (n, 3) radiance
    of the s >= 1, t >= 2 strategies, its bits; ``occl`` (default
    ``accel.occluded``) is called once a strategy, as there, and
    ``stats_acc["rays_shadow"]`` gains the candidate connections' count."""
    from tputracer_torch.accel import occluded

    occl = occluded if occl is None else occl
    n_verts = cfg.max_bounces + 2
    ptrs = vertex_table(scene, ys, zs)
    dev = zs[0]["beta"].device
    n = zs[0]["beta"].shape[0]
    n_s = len(strategies(len(zs), len(ys), n_verts))
    if n_s == 0 or n == 0:
        return torch.zeros((n, 3), dtype=torch.float32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    orig = torch.empty((n_s, n, 3), **f32)
    dirs = torch.empty((n_s, n, 3), **f32)
    contrib = torch.empty((n_s, n, 3), **f32)
    tmax = torch.empty((n_s, n), **f32)
    mask = torch.empty((n_s, n), dtype=torch.bool, device=dev)
    table = torch.empty(len(ptrs), dtype=torch.int64, device=dev)
    args = (len(zs), len(ys), n_verts, n)
    LIB.launch("tpt_connect_prepare", dev,
               (ctypes.c_longlong * len(ptrs))(*ptrs), len(ptrs), table,
               *args, scene.mat_kind, scene.mat_albedo, scene.eps, orig, dirs,
               tmax, contrib, mask)
    # only candidate connections trace shadow rays (tmax = 0 on the rest);
    # their count is the shadow-ray stat, added a strategy at a time as the
    # torch version adds it, so the float32 running sum rounds alike once
    # it passes 2^24
    if stats_acc is not None:
        for count in mask.sum(dim=1, dtype=torch.float32):
            stats_acc["rays_shadow"] = (stats_acc.get("rays_shadow", 0.0)
                                        + count)
    # held until the second kernel is queued, so no allocation reuses their
    # memory before it reads them
    occs = [occl(scene, orig[k], dirs[k], tmax=tmax[k]) for k in range(n_s)]
    occ_ptrs = occlusion_table(occs, n, dev, _WHO)
    out = torch.empty((n, 3), **f32)
    occ_table = torch.empty(n_s, dtype=torch.int64, device=dev)
    LIB.launch("tpt_connect_finish", dev,
               (ctypes.c_longlong * n_s)(*occ_ptrs), n_s, occ_table, table,
               *args, int(bool(cfg.mis_power)), scene.mat_kind, contrib, mask,
               out)
    return out


def t1_splats_cuda(scene, cfg, ys, zs, occl=None, stats_acc=None):
    """``bdpt.t1_splats_plain`` on the card: the (H * W, 3) film of the
    t = 1 splats, each splat's contribution and pixel its bits, summed in
    no fixed order (float atomics, as ``index_add_`` adds); ``occl``
    (default ``accel.occluded``) is called once a strategy, as there, and
    ``stats_acc["rays_shadow"]`` gains the candidate splats' count.  The
    camera comes from ``scene.camera``; ``zs`` is not read."""
    from tputracer_torch.accel import occluded
    from tputracer_torch.integrators.bdpt import _splat_camera

    occl = occluded if occl is None else occl
    n_verts = cfg.max_bounces + 2
    dev = ys[0]["beta"].device
    n = ys[0]["beta"].shape[0]
    cam = scene.camera
    cam_ptrs = [check(_SPLAT, f"camera {f}", getattr(cam, f), torch.float32,
                      (3,), dev) for f in CAMERA_FIELDS]
    ptrs = vertex_table(scene, ys, who=_SPLAT)
    n_pix = cfg.width * cfg.height
    if n_pix >= 1 << 31:
        raise ValueError(f"{_SPLAT}: {n_pix} pixels pass the kernels' int32 "
                         f"pixel ids")
    n_s = len(splat_strategies(len(ys), n_verts))
    f32 = dict(dtype=torch.float32, device=dev)
    film = torch.zeros((n_pix, 3), **f32)
    if n_s == 0 or n == 0:
        return film
    fwd, area, du2, dv2 = _splat_camera(cam)
    orig = torch.empty((n, 3), **f32)
    dirs = torch.empty((n_s, n, 3), **f32)
    contrib = torch.empty((n_s, n, 3), **f32)
    tmax = torch.empty((n_s, n), **f32)
    mask = torch.empty((n_s, n), dtype=torch.bool, device=dev)
    pix = torch.empty((n_s, n), dtype=torch.int32, device=dev)
    table = torch.empty(len(ptrs), dtype=torch.int64, device=dev)
    args = (len(ys), n_verts, n)
    LIB.launch("tpt_splat_prepare", dev,
               (ctypes.c_longlong * len(ptrs))(*ptrs), len(ptrs), table,
               *args, cfg.width, cfg.height, scene.mat_kind,
               scene.mat_albedo, *cam_ptrs, fwd, area, du2, dv2,
               orig, dirs, tmax, contrib, mask, pix)
    # the candidates' count, a strategy at a time as the torch version adds
    # it (see connection_radiance_cuda)
    if stats_acc is not None:
        for count in mask.sum(dim=1, dtype=torch.float32):
            stats_acc["rays_shadow"] = (stats_acc.get("rays_shadow", 0.0)
                                        + count)
    # every strategy's shadow rays leave the camera: one origin buffer
    occs = [occl(scene, orig, dirs[k], tmax=tmax[k]) for k in range(n_s)]
    occ_ptrs = occlusion_table(occs, n, dev, _SPLAT)
    occ_table = torch.empty(n_s, dtype=torch.int64, device=dev)
    LIB.launch("tpt_splat_finish", dev,
               (ctypes.c_longlong * n_s)(*occ_ptrs), n_s, occ_table, table,
               *args, int(bool(cfg.mis_power)), scene.mat_kind, cam.o, fwd,
               area, contrib, mask, pix, film)
    return film
