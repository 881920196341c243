"""BDPT's connection strategies on the card: ``csrc/connect.cu``.

:func:`connection_radiance_cuda` computes what
``bdpt.connection_radiance_plain`` computes, the s >= 1, t >= 2
strategies' radiance of a chunk, in two kernels around the shadow rays:
``connect_prepare_kernel`` writes every strategy's shadow ray,
contribution and candidate mask into (S, n) buffers, the caller's
``occl`` traces the S shadow-ray batches as the torch version does (one
call a strategy), and ``connect_finish_kernel`` weighs each surviving
connection by MIS and sums them.  The kernels read the walks' vertex
tensors in place, through a table of their pointers that a small kernel
(``connect_table_kernel``) fills on the device.

``bdpt.connection_radiance`` routes: vertices on a CUDA device with no
gradient wanted come here; CPU vertices, and gradient calls, take the
torch version, which is also the kernels' oracle.  The kernels have no
backward.  Built at first use (``cuda_build``), never at import.
"""

from __future__ import annotations

import ctypes

import torch

from tputracer_torch.cuda_build import Library, check

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
                           ["connect_finish_kernel"])},
    uncounted=["connect_table_kernel"])


def strategies(n_eye, n_light, n_verts):
    """The (s, t) connection strategies of eye and light subpaths of
    ``n_eye`` and ``n_light`` vertices at ``n_verts`` = max_bounces + 2,
    in ``connection_radiance``'s order."""
    return [(s, t) for t in range(2, n_eye + 1)
            for s in range(1, min(n_light, n_verts - t) + 1)]


def vertex_table(scene, ys, zs):
    """The pointers of the kernels' vertex table (zs, then ys, the fields
    in :data:`FIELDS`' order, 0 for a field never read), after checking
    every tensor the kernels read: on one device, contiguous, of its
    dtype and shape, and that device a CUDA one.  Raises ValueError on
    anything else, before any build or launch."""
    dev = zs[0]["beta"].device
    n = zs[0]["beta"].shape[0]
    ptrs = []
    for v, vert in enumerate(list(zs) + list(ys)):
        for f, (dtype, tail) in FIELDS.items():
            ptrs.append(0 if (v, f) in _UNREAD else check(
                _WHO, f"vertex {v}'s {f}", vert[f], dtype, (n,) + tail, dev))
    check(_WHO, "mat_kind", scene.mat_kind, torch.int32,
          scene.mat_kind.shape[:1], dev)
    check(_WHO, "mat_albedo", scene.mat_albedo, torch.float32,
          (scene.mat_kind.shape[0], 3), dev)
    if dev.type != "cuda":
        raise ValueError(f"{_WHO}: want CUDA vertices, got {dev}")
    return ptrs


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
    occ_ptrs = [check(_WHO, f"occlusion result {k}", o, torch.bool, (n,), dev)
                for k, o in enumerate(occs)]
    out = torch.empty((n, 3), **f32)
    occ_table = torch.empty(n_s, dtype=torch.int64, device=dev)
    LIB.launch("tpt_connect_finish", dev,
               (ctypes.c_longlong * n_s)(*occ_ptrs), n_s, occ_table, table,
               *args, int(bool(cfg.mis_power)), scene.mat_kind, contrib, mask,
               out)
    return out
