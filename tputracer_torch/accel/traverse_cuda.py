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

The route is by the cluster count alone: up to
``tpt_traverse_max_clusters()`` clusters (9,685 on Hopper, as many boxes
as one block's shared memory holds) the kernel scans every cluster box
(``tpt_traverse``); above it walks the scene's top level first
(``tpt_traverse_tree``, accel.toptree), with the same (t, prim).  The
tree walk counts its work into a per-stream device buffer
(:func:`tree_counts`): the boxes it slab-tests, the clusters it visits
and the live rays it walks.

Not ported, as TPU workarounds (traverse_tpu.py): the live-first
compaction ``_compacted_traverse`` (it only permutes rays and undoes the
permutation, so it changes no (t, prim)), the bf16 slab ``_prep_boxes``
and the TILE/SUB overrides.
"""

from __future__ import annotations

import ctypes

import torch

from tputracer_torch import cuda_build
from tputracer_torch.accel.clustered import (_traverse, closest_clustered,
                                             intersect_clustered,
                                             occluded_clustered)
from tputracer_torch.accel.toptree import FANOUT
from tputracer_torch.cuda_build import Library, check, scratch

_p, _i = ctypes.c_void_p, ctypes.c_int
# its memset of the ray counter is not a kernel node
LIB = Library("traverse.cu", "tpt_traverse_error_string", {
    "tpt_traverse": ([_p, _p, _p, _p,          # o, d, tmin, tmax
                      _p, _p,                  # bt0, bp0
                      _p, _p, _i,              # cmin, cmax, n_clusters
                      _p, _p, _p, _p,          # plu, trin, v0n, mask
                      _i, _i, _i, _i,          # leaf, n_tri, n_rays, any_hit
                      _p, _p, _p],             # t_out, prim_out, next_ray
                     ["traverse_kernel"]),
    # the tree walk: another instance of the kernel's name
    "tpt_traverse_tree": ([_p, _p, _p, _p,     # o, d, tmin, tmax
                           _p, _p,             # bt0, bp0
                           _p, _p, _i,         # cmin, cmax, n_clusters
                           _p, _p, _i,         # top_min, top_max, n_nodes
                           _p, _p, _p, _p,     # plu, trin, v0n, mask
                           _i, _i, _i, _i,     # leaf, n_tri, n_rays, any_hit
                           _p, _p, _p,         # t_out, prim_out, next_ray
                           _p],                # counts
                          ["traverse_kernel"])})


def __getattr__(name):
    if name == "LAUNCHES":   # read by the benchmark (perfbench/program.py)
        return cuda_build.LAUNCHES["traverse_kernel"]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def traverse_cuda(o, d, tmin, tmax, bt0, bp0, cmin, cmax, plu, trin, v0n,
                  mask, top_min, top_max, leaf, any_hit=False, tree=None):
    """Launch the kernel on CUDA tensors: (t (N,) f32, prim (N,) i32).

    Same contract as accel.clustered._traverse; with any_hit, t < tmax is
    the occlusion verdict and t is the first hit found.  ``tree`` None
    routes by the cluster count, True takes the tree walk and False the
    flat scan at any count."""
    dev = o.device
    if dev.type != "cuda":
        raise ValueError(f"traverse_cuda needs CUDA tensors, got {dev}")
    n, C, T = o.shape[0], cmin.shape[0], plu.shape[2]
    if leaf <= 0 or T != C * leaf:
        raise ValueError(f"{T} triangle slots are not {C} clusters of {leaf}")
    f32, i32 = torch.float32, torch.int32
    who = "traverse_cuda"
    check(who, "o", o, f32, (n, 3), dev)
    check(who, "d", d, f32, (n, 3), dev)
    check(who, "tmin", tmin, f32, (n,), dev)
    check(who, "tmax", tmax, f32, (n,), dev)
    check(who, "bt0", bt0, f32, (n,), dev)
    check(who, "bp0", bp0, i32, (n,), dev)
    check(who, "cmin", cmin, f32, (C, 3), dev)
    check(who, "cmax", cmax, f32, (C, 3), dev)
    check(who, "plu", plu, f32, (3, 6, T), dev)
    check(who, "trin", trin, f32, (T, 3), dev)
    check(who, "v0n", v0n, f32, (T,), dev)
    check(who, "mask", mask, f32, (T,), dev)
    t = torch.empty((n,), dtype=f32, device=dev)
    prim = torch.empty((n,), dtype=i32, device=dev)
    if n == 0:
        return t, prim
    max_boxes = LIB.limit("tpt_traverse_max_clusters")
    if tree is None:
        tree = C > max_boxes
    # zeroed by tpt_traverse(_tree) on its stream
    next_ray = scratch(who, "ray counter", dev, 1, i32)
    if not tree:
        if C > max_boxes:
            raise ValueError(
                f"{C} clusters: the flat scan stages every cluster box in "
                f"one block's shared memory, which holds at most "
                f"{max_boxes}")
        LIB.launch("tpt_traverse", dev, o, d, tmin, tmax, bt0, bp0, cmin,
                   cmax, C, plu, trin, v0n, mask, leaf, T, n, int(any_hit),
                   t, prim, next_ray)
        return t, prim
    G = -(-C // FANOUT)
    check(who, "top_min", top_min, f32, (G, 3), dev)
    check(who, "top_max", top_max, f32, (G, 3), dev)
    if G > max_boxes:
        raise ValueError(
            f"{C} clusters: the tree walk stages its {G} top node boxes in "
            f"one block's shared memory, which holds at most {max_boxes}")
    LIB.launch("tpt_traverse_tree", dev, o, d, tmin, tmax, bt0, bp0, cmin,
               cmax, C, top_min, top_max, G, plu, trin, v0n, mask, leaf, T,
               n, int(any_hit), t, prim, next_ray, counts_of(dev))
    return t, prim


def counts_of(device):
    """The tree walk's counters of ``device``'s current stream: (3,) int64
    on the device, the boxes slab-tested, the clusters visited and the
    live rays walked, summed over every launch since they were zeroed."""
    return scratch("traverse_cuda", "walk counts", device, 3, torch.int64,
                   fill=0)


def tree_counts(scene):
    """:func:`counts_of` the scene's device, zeroed (on its current stream,
    so inside a graph's capture at each replay), where a walk of ``scene``
    on its device is the tree walk; else None."""
    dev = scene.device
    if (dev.type != "cuda" or not scene.n_clusters or scene.n_clusters
            <= LIB.limit("tpt_traverse_max_clusters")):
        return None
    return counts_of(dev).zero_()


def traverse(o, d, tmin, tmax, bt0, bp0, cmin, cmax, plu, trin, v0n, mask,
             top_min, top_max, leaf, any_hit=False):
    """The kernel on a CUDA tensor, the plain version on a CPU tensor.
    Tables as accel.clustered.traverse_args gives them."""
    args = (o, d, tmin, tmax, bt0, bp0, cmin, cmax, plu, trin, v0n, mask,
            top_min, top_max)
    if o.device.type == "cuda":
        return traverse_cuda(*args, leaf=leaf, any_hit=any_hit)
    if o.device.type == "cpu":
        return _traverse(*args, leaf=leaf, any_hit=any_hit)
    raise ValueError(f"no traversal route for device {o.device}")


def closest_traverse(scene, o, d, tmin, tmax):
    """(t, prim) of the closest hit through the cluster BVH, via
    :func:`traverse`."""
    return closest_clustered(scene, o, d, tmin, tmax, walk=traverse)


def intersect_traverse(scene, o, d, tmin, tmax):
    """Closest hit through the cluster BVH (Hit SoA), via :func:`traverse`."""
    return intersect_clustered(scene, o, d, tmin, tmax, walk=traverse)


def occluded_traverse(scene, o, d, tmax):
    """Any-hit shadow predicate through the cluster BVH, via :func:`traverse`."""
    return occluded_clustered(scene, o, d, tmax, walk=traverse)
