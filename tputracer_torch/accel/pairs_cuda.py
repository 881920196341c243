"""Pair-expansion traversal: the CUDA kernels' wrappers.

Port of the two Pallas kernels of ``tputracer/accel/pairs_tpu.py``:
:func:`expand_cuda` launches ``expand_kernel`` and :func:`pairtest_cuda`
``pairtest_kernel``, both of ``csrc/pairs.cu`` (one library, built at first
use).  The pair test also does the route's old glue: it reads the slots
through the sort's permutation and folds each ray's K slots itself.  They
take CUDA tensors only; the dispatch and the plain versions are in
accel.pairs.
"""

from __future__ import annotations

import ctypes

import torch

from tputracer_torch import cuda_build
from tputracer_torch.cuda_build import Library, check, drop_scratch, scratch

_p, _i = ctypes.c_void_p, ctypes.c_int
LIB = Library("pairs.cu", "tpt_pairs_error_string", {
    "tpt_pair_expand": ([_p, _p, _p, _p,       # o, d, tmin, tmax
                         _p, _p, _i,           # cmin, cmax, n_clusters
                         _i, _i,               # n_rays, k_slots
                         _p, _p, _p],          # cid, te, bound
                        ["expand_kernel"]),
    "tpt_pair_test": ([_p, _p, _p, _p, _p,     # o, d, tmin, bt0, bp0
                       _p, _p, _p,             # sidx, cid, te
                       _p, _p, _p, _p,         # v0, e1, e2, mask
                       _i, _i, _i,             # leaf, k_slots, n_rays
                       _p,                     # keys
                       _p, _p],                # t_out, p_out
                      ["pairtest_kernel", "fold_kernel"])})


def __getattr__(name):
    if name == "PAIRTEST_LAUNCHES":   # read by the benchmark (perfbench/)
        return cuda_build.LAUNCHES["pairtest_kernel"]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def expand_cuda(o, d, tmin, tmax, cmin, cmax, k):
    """Launch the expand kernel on CUDA tensors: (cid (N,k) i32,
    te (N,k) f32, bound (N,) f32), as pairs.expand_plain."""
    dev = o.device
    if dev.type != "cuda":
        raise ValueError(f"expand_cuda needs CUDA tensors, got {dev}")
    n, C = o.shape[0], cmin.shape[0]
    f32 = torch.float32
    who = "expand_cuda"
    check(who, "o", o, f32, (n, 3), dev)
    check(who, "d", d, f32, (n, 3), dev)
    check(who, "tmin", tmin, f32, (n,), dev)
    check(who, "tmax", tmax, f32, (n,), dev)
    check(who, "cmin", cmin, f32, (C, 3), dev)
    check(who, "cmax", cmax, f32, (C, 3), dev)
    cid = torch.empty((n, k), dtype=torch.int32, device=dev)
    te = torch.empty((n, k), dtype=f32, device=dev)
    bound = torch.empty((n,), dtype=f32, device=dev)
    if n == 0:
        return cid, te, bound
    max_slots = LIB.limit("tpt_pairs_max_slots")
    if not 2 <= k <= max_slots:
        raise ValueError(f"{k} slots: the expand kernel takes 2 to "
                         f"{max_slots}")
    max_clusters = LIB.limit("tpt_pairs_max_clusters")
    if C > max_clusters:
        raise ValueError(
            f"{C} clusters: the expand kernel stages every cluster AABB in "
            f"one block's shared memory, which holds at most {max_clusters}")
    LIB.launch("tpt_pair_expand", dev, o, d, tmin, tmax, cmin, cmax, C, n, k,
               cid, te, bound)
    return cid, te, bound


def pairtest_cuda(o, d, tmin, bt0, bp0, sidx, cid, te, v0, e1, e2, mask,
                  leaf):
    """Launch the pair-test kernel on CUDA tensors: each ray's folded
    (best_t (N,) f32, best_p (N,) i32), as pairs.pairtest_plain.  sidx
    (N*K,) i64 permutes the slots into cluster order; cid, te (N,K)."""
    dev = o.device
    if dev.type != "cuda":
        raise ValueError(f"pairtest_cuda needs CUDA tensors, got {dev}")
    n, k, T = o.shape[0], cid.shape[-1], v0.shape[0]
    if leaf <= 0 or T % leaf:
        raise ValueError(f"{T} triangle slots are not clusters of {leaf}")
    f32 = torch.float32
    who = "pairtest_cuda"
    check(who, "o", o, f32, (n, 3), dev)
    check(who, "d", d, f32, (n, 3), dev)
    check(who, "tmin", tmin, f32, (n,), dev)
    check(who, "bt0", bt0, f32, (n,), dev)
    check(who, "bp0", bp0, torch.int32, (n,), dev)
    check(who, "sidx", sidx, torch.int64, (n * k,), dev)
    check(who, "cid", cid, torch.int32, (n, k), dev)
    check(who, "te", te, f32, (n, k), dev)
    check(who, "v0", v0, f32, (T, 3), dev)
    check(who, "e1", e1, f32, (T, 3), dev)
    check(who, "e2", e2, f32, (T, 3), dev)
    check(who, "mask", mask, f32, (T,), dev)
    t = torch.empty((n,), dtype=f32, device=dev)
    p = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return t, p
    max_slots = LIB.limit("tpt_pairs_max_slots")
    if not 1 <= k <= max_slots:
        raise ValueError(f"{k} slots: the pair test takes 1 to {max_slots}")
    prim_bits = LIB.limit("tpt_pairs_prim_bits")
    if T > 1 << prim_bits:
        raise ValueError(f"{T} triangle slots: the fold key holds prims "
                         f"below 2^{prim_bits}")
    max_leaf = LIB.limit("tpt_pairs_max_leaf")
    if leaf > max_leaf:
        raise ValueError(f"leaf {leaf}: the pair test stages at most "
                         f"{max_leaf} slots a cluster")
    # all ones; the fold kernel leaves them so, and a call launches no
    # memset (a CUDA graph's replay relies on it)
    keys = scratch(who, "fold keys", dev, n, torch.int64, fill=-1)
    try:
        LIB.launch("tpt_pair_test", dev, o, d, tmin, bt0, bp0, sidx, cid, te,
                   v0, e1, e2, mask, leaf, k, n, keys, t, p)
    except RuntimeError:   # the fold may not have run: not all ones
        drop_scratch("fold keys", dev)
        raise
    return t, p
