"""Cluster-BVH traversal: the CUDA kernel and its wrappers.

Port of ``tputracer/accel/traverse_tpu.py``.  On a CUDA tensor
:func:`traverse` launches ``csrc/traverse.cu`` (built at first use), in
which a warp walks each ray; on a CPU tensor it runs the kernel's plain
version, accel.clustered._traverse.  There is no other route.
``intersect_traverse``/``occluded_traverse`` put the sphere preamble
(``_sphere_best``, ``bt0 = min(bt0, tmax)``) in front, as
``intersect_pallas``/``occluded_pallas`` do.

The kernel reads the scene's tables in their own layout
(accel.clustered.traverse_args: Pluecker coordinates as (3, 6, T)), so a
call copies no table.

Not ported, as TPU workarounds (traverse_tpu.py): the live-first
compaction ``_compacted_traverse`` (it only permutes rays and undoes the
permutation, so it changes no (t, prim)), the bf16 slab ``_prep_boxes``
and the TILE/SUB overrides.
"""

from __future__ import annotations

import ctypes

import torch

from tputracer_torch.accel.clustered import (_traverse, intersect_clustered,
                                             occluded_clustered)
from tputracer_torch.accel.intersect_cuda import _check

# kernel launches made by this module's wrapper since the last reset
LAUNCHES = 0

_FN = None
# the kernel's ray counter, one int per (device, stream), kept between calls
# (and by the CUDA graphs that captured it, graphs.Graph.scratch)
_COUNTERS: dict = {}


def load_kernel():
    """Build (first use) and load the CUDA kernel; returns
    (fn, errstr, max_clusters)."""
    global _FN
    if _FN is None:
        from tputracer_torch.cuda_build import load_library

        lib = load_library("traverse.cu")
        fn = lib.tpt_traverse
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p,          # o, d, tmin, tmax
                       p, p,                # bt0, bp0
                       p, p, i,             # cmin, cmax, n_clusters
                       p, p, p, p,          # plu, trin, v0n, mask
                       i, i, i, i,          # leaf, n_tri, n_rays, any_hit
                       p, p, p, p]          # t_out, prim_out, next_ray, stream
        fn.restype = i
        lib.tpt_traverse_error_string.argtypes = [i]
        lib.tpt_traverse_error_string.restype = ctypes.c_char_p
        lib.tpt_traverse_max_clusters.restype = i
        _FN = (fn, lib.tpt_traverse_error_string,
               lib.tpt_traverse_max_clusters())
    return _FN


def traverse_cuda(o, d, tmin, tmax, bt0, bp0, cmin, cmax, plu, trin, v0n,
                  mask, leaf, any_hit=False):
    """Launch the kernel on CUDA tensors: (t (N,) f32, prim (N,) i32).

    Same contract as accel.clustered._traverse; with any_hit, t < tmax is
    the occlusion verdict and t is the first hit found."""
    global LAUNCHES
    dev = o.device
    if dev.type != "cuda":
        raise ValueError(f"traverse_cuda needs CUDA tensors, got {dev}")
    n, C, T = o.shape[0], cmin.shape[0], plu.shape[2]
    if leaf <= 0 or T != C * leaf:
        raise ValueError(f"{T} triangle slots are not {C} clusters of {leaf}")
    f32, i32 = torch.float32, torch.int32
    _check(o, "o", (n, 3), f32, dev)
    _check(d, "d", (n, 3), f32, dev)
    _check(tmin, "tmin", (n,), f32, dev)
    _check(tmax, "tmax", (n,), f32, dev)
    _check(bt0, "bt0", (n,), f32, dev)
    _check(bp0, "bp0", (n,), i32, dev)
    _check(cmin, "cmin", (C, 3), f32, dev)
    _check(cmax, "cmax", (C, 3), f32, dev)
    _check(plu, "plu", (3, 6, T), f32, dev)
    _check(trin, "trin", (T, 3), f32, dev)
    _check(v0n, "v0n", (T,), f32, dev)
    _check(mask, "mask", (T,), f32, dev)
    t = torch.empty((n,), dtype=f32, device=dev)
    prim = torch.empty((n,), dtype=i32, device=dev)
    if n == 0:
        return t, prim
    fn, errstr, max_clusters = load_kernel()
    if C > max_clusters:
        raise ValueError(
            f"{C} clusters: the kernel stages every cluster AABB in one "
            f"block's shared memory, which holds at most {max_clusters}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        key = (dev.index, stream)
        next_ray = _COUNTERS.get(key)
        if next_ray is None:   # zeroed by tpt_traverse on this stream
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "traverse_cuda: this stream's ray counter must exist "
                    "before a CUDA graph capture (one call on the capture "
                    "stream first), or it would live in the graph's pool")
            next_ray = _COUNTERS[key] = torch.empty((1,), dtype=i32,
                                                    device=dev)
        err = fn(o.data_ptr(), d.data_ptr(), tmin.data_ptr(), tmax.data_ptr(),
                 bt0.data_ptr(), bp0.data_ptr(), cmin.data_ptr(),
                 cmax.data_ptr(), C, plu.data_ptr(), trin.data_ptr(),
                 v0n.data_ptr(), mask.data_ptr(), leaf, T, n, int(any_hit),
                 t.data_ptr(), prim.data_ptr(), next_ray.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"tpt_traverse launch failed: "
                           f"{errstr(err).decode()} ({err})")
    LAUNCHES += 1
    return t, prim


def traverse(o, d, tmin, tmax, bt0, bp0, cmin, cmax, plu, trin, v0n, mask,
             leaf, any_hit=False):
    """The kernel on a CUDA tensor, the plain version on a CPU tensor.
    Tables as accel.clustered.traverse_args gives them."""
    args = (o, d, tmin, tmax, bt0, bp0, cmin, cmax, plu, trin, v0n, mask)
    if o.device.type == "cuda":
        return traverse_cuda(*args, leaf=leaf, any_hit=any_hit)
    if o.device.type == "cpu":
        return _traverse(*args, leaf=leaf, any_hit=any_hit)
    raise ValueError(f"no traversal route for device {o.device}")


def intersect_traverse(scene, o, d, tmin, tmax):
    """Closest hit through the cluster BVH (Hit SoA), via :func:`traverse`."""
    return intersect_clustered(scene, o, d, tmin, tmax, walk=traverse)


def occluded_traverse(scene, o, d, tmax):
    """Any-hit shadow predicate through the cluster BVH, via :func:`traverse`."""
    return occluded_clustered(scene, o, d, tmax, walk=traverse)
