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

from tputracer_torch.accel.intersect_cuda import _check

# kernel launches made by this module's wrappers since the last reset
EXPAND_LAUNCHES = 0
PAIRTEST_LAUNCHES = 0

_LIB = None
# the pair test's fold keys (all ones), per (device, stream): its fold
# kernel leaves them so, and a call launches no memset
_KEYS: dict = {}


def load_kernel():
    """Build (first use) and load the library; returns (expand_fn,
    pairtest_fn, errstr, limits), limits a dict of max_clusters,
    max_leaf, max_slots and prim_bits."""
    global _LIB
    if _LIB is None:
        from tputracer_torch.cuda_build import load_library

        lib = load_library("pairs.cu")
        p, i = ctypes.c_void_p, ctypes.c_int
        expand = lib.tpt_pair_expand
        expand.argtypes = [p, p, p, p,      # o, d, tmin, tmax
                           p, p, i,         # cmin, cmax, n_clusters
                           i, i,            # n_rays, k_slots
                           p, p, p, p]      # cid, te, bound, stream
        expand.restype = i
        test = lib.tpt_pair_test
        test.argtypes = [p, p, p, p, p,     # o, d, tmin, bt0, bp0
                         p, p, p,           # sidx, cid, te
                         p, p, p, p,        # v0, e1, e2, mask
                         i, i, i,           # leaf, k_slots, n_rays
                         p,                 # keys
                         p, p, p]           # t_out, p_out, stream
        test.restype = i
        lib.tpt_pairs_error_string.argtypes = [i]
        lib.tpt_pairs_error_string.restype = ctypes.c_char_p
        limits = {}
        for name in ("max_clusters", "max_leaf", "max_slots", "prim_bits"):
            fn = getattr(lib, f"tpt_pairs_{name}")
            fn.restype = i
            limits[name] = fn()
        _LIB = (expand, test, lib.tpt_pairs_error_string, limits)
    return _LIB


def _raise_on(err, name, errstr):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {errstr(err).decode()} "
                           f"({err})")


def expand_cuda(o, d, tmin, tmax, cmin, cmax, k):
    """Launch the expand kernel on CUDA tensors: (cid (N,k) i32,
    te (N,k) f32, bound (N,) f32), as pairs.expand_plain."""
    global EXPAND_LAUNCHES
    dev = o.device
    if dev.type != "cuda":
        raise ValueError(f"expand_cuda needs CUDA tensors, got {dev}")
    n, C = o.shape[0], cmin.shape[0]
    f32 = torch.float32
    _check(o, "o", (n, 3), f32, dev)
    _check(d, "d", (n, 3), f32, dev)
    _check(tmin, "tmin", (n,), f32, dev)
    _check(tmax, "tmax", (n,), f32, dev)
    _check(cmin, "cmin", (C, 3), f32, dev)
    _check(cmax, "cmax", (C, 3), f32, dev)
    cid = torch.empty((n, k), dtype=torch.int32, device=dev)
    te = torch.empty((n, k), dtype=f32, device=dev)
    bound = torch.empty((n,), dtype=f32, device=dev)
    if n == 0:
        return cid, te, bound
    expand, _, errstr, limits = load_kernel()
    if not 2 <= k <= limits["max_slots"]:
        raise ValueError(f"{k} slots: the expand kernel takes 2 to "
                         f"{limits['max_slots']}")
    if C > limits["max_clusters"]:
        raise ValueError(
            f"{C} clusters: the expand kernel stages every cluster AABB in "
            f"one block's shared memory, which holds at most "
            f"{limits['max_clusters']}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = expand(o.data_ptr(), d.data_ptr(), tmin.data_ptr(),
                     tmax.data_ptr(), cmin.data_ptr(), cmax.data_ptr(), C, n,
                     k, cid.data_ptr(), te.data_ptr(), bound.data_ptr(),
                     stream)
    _raise_on(err, "tpt_pair_expand", errstr)
    EXPAND_LAUNCHES += 1
    return cid, te, bound


def _keys(dev, stream, n):
    """The fold keys of (device, stream): at least n, all ones."""
    keys = _KEYS.get((dev.index, stream))
    if keys is None or keys.shape[0] < n:
        cap = max(n, 2 * keys.shape[0] if keys is not None else n)
        keys = torch.full((cap,), -1, dtype=torch.int64, device=dev)
        _KEYS[(dev.index, stream)] = keys
    return keys


def pairtest_cuda(o, d, tmin, bt0, bp0, sidx, cid, te, v0, e1, e2, mask,
                  leaf):
    """Launch the pair-test kernel on CUDA tensors: each ray's folded
    (best_t (N,) f32, best_p (N,) i32), as pairs.pairtest_plain.  sidx
    (N*K,) i64 permutes the slots into cluster order; cid, te (N,K)."""
    global PAIRTEST_LAUNCHES
    dev = o.device
    if dev.type != "cuda":
        raise ValueError(f"pairtest_cuda needs CUDA tensors, got {dev}")
    n, k, T = o.shape[0], cid.shape[-1], v0.shape[0]
    if leaf <= 0 or T % leaf:
        raise ValueError(f"{T} triangle slots are not clusters of {leaf}")
    f32 = torch.float32
    _check(o, "o", (n, 3), f32, dev)
    _check(d, "d", (n, 3), f32, dev)
    _check(tmin, "tmin", (n,), f32, dev)
    _check(bt0, "bt0", (n,), f32, dev)
    _check(bp0, "bp0", (n,), torch.int32, dev)
    _check(sidx, "sidx", (n * k,), torch.int64, dev)
    _check(cid, "cid", (n, k), torch.int32, dev)
    _check(te, "te", (n, k), f32, dev)
    _check(v0, "v0", (T, 3), f32, dev)
    _check(e1, "e1", (T, 3), f32, dev)
    _check(e2, "e2", (T, 3), f32, dev)
    _check(mask, "mask", (T,), f32, dev)
    t = torch.empty((n,), dtype=f32, device=dev)
    p = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return t, p
    _, test, errstr, limits = load_kernel()
    if not 1 <= k <= limits["max_slots"]:
        raise ValueError(f"{k} slots: the pair test takes 1 to "
                         f"{limits['max_slots']}")
    if T > 1 << limits["prim_bits"]:
        raise ValueError(f"{T} triangle slots: the fold key holds prims "
                         f"below 2^{limits['prim_bits']}")
    if leaf > limits["max_leaf"]:
        raise ValueError(f"leaf {leaf}: the pair test stages at most "
                         f"{limits['max_leaf']} slots a cluster")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        keys = _keys(dev, stream, n)
        err = test(o.data_ptr(), d.data_ptr(), tmin.data_ptr(),
                   bt0.data_ptr(), bp0.data_ptr(), sidx.data_ptr(),
                   cid.data_ptr(), te.data_ptr(), v0.data_ptr(),
                   e1.data_ptr(), e2.data_ptr(), mask.data_ptr(), leaf, k, n,
                   keys.data_ptr(), t.data_ptr(), p.data_ptr(), stream)
    if err != 0:   # the fold may not have run: its keys are not all ones
        _KEYS.pop((dev.index, stream), None)
    _raise_on(err, "tpt_pair_test", errstr)
    PAIRTEST_LAUNCHES += 1
    return t, p
