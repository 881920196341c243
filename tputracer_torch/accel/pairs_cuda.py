"""Pair-expansion traversal: the CUDA kernels' wrappers.

Port of the two Pallas kernels of ``tputracer/accel/pairs_tpu.py``:
:func:`expand_cuda` launches ``expand_kernel`` and :func:`pairtest_cuda`
``pairtest_kernel``, both of ``csrc/pairs.cu`` (one library, built at first
use).  They take CUDA tensors only; the dispatch and the plain versions
are in accel.pairs.
"""

from __future__ import annotations

import ctypes

import torch

from tputracer_torch.accel.intersect_cuda import _check

# kernel launches made by this module's wrappers since the last reset
EXPAND_LAUNCHES = 0
PAIRTEST_LAUNCHES = 0

_LIB = None


def load_kernel():
    """Build (first use) and load the library; returns (expand_fn,
    pairtest_fn, errstr, max_clusters, max_slots)."""
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
        test.argtypes = [p, p, p,           # o, d, tmin
                         p, p, p,           # cid, te, bt
                         p, p, p, p,        # v0, e1, e2, mask
                         i, i,              # leaf, n_pairs
                         p, p, p]           # t_out, p_out, stream
        test.restype = i
        lib.tpt_pairs_error_string.argtypes = [i]
        lib.tpt_pairs_error_string.restype = ctypes.c_char_p
        lib.tpt_pairs_max_clusters.restype = i
        lib.tpt_pairs_max_slots.restype = i
        _LIB = (expand, test, lib.tpt_pairs_error_string,
                lib.tpt_pairs_max_clusters(), lib.tpt_pairs_max_slots())
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
    expand, _, errstr, max_clusters, max_slots = load_kernel()
    if not 2 <= k <= max_slots:
        raise ValueError(f"{k} slots: the expand kernel takes 2 to "
                         f"{max_slots}")
    if C > max_clusters:
        raise ValueError(
            f"{C} clusters: the expand kernel stages every cluster AABB in "
            f"one block's shared memory, which holds at most {max_clusters}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = expand(o.data_ptr(), d.data_ptr(), tmin.data_ptr(),
                     tmax.data_ptr(), cmin.data_ptr(), cmax.data_ptr(), C, n,
                     k, cid.data_ptr(), te.data_ptr(), bound.data_ptr(),
                     stream)
    _raise_on(err, "tpt_pair_expand", errstr)
    EXPAND_LAUNCHES += 1
    return cid, te, bound


def pairtest_cuda(o, d, tmin, cid, te, bt, v0, e1, e2, mask, leaf):
    """Launch the pair-test kernel on CUDA tensors: (t (P,) f32,
    p (P,) i32), as pairs.pairtest_plain."""
    global PAIRTEST_LAUNCHES
    dev = o.device
    if dev.type != "cuda":
        raise ValueError(f"pairtest_cuda needs CUDA tensors, got {dev}")
    n, T = o.shape[0], v0.shape[0]
    if leaf <= 0 or T % leaf:
        raise ValueError(f"{T} triangle slots are not clusters of {leaf}")
    f32 = torch.float32
    _check(o, "o", (n, 3), f32, dev)
    _check(d, "d", (n, 3), f32, dev)
    _check(tmin, "tmin", (n,), f32, dev)
    _check(cid, "cid", (n,), torch.int32, dev)
    _check(te, "te", (n,), f32, dev)
    _check(bt, "bt", (n,), f32, dev)
    _check(v0, "v0", (T, 3), f32, dev)
    _check(e1, "e1", (T, 3), f32, dev)
    _check(e2, "e2", (T, 3), f32, dev)
    _check(mask, "mask", (T,), f32, dev)
    t = torch.empty((n,), dtype=f32, device=dev)
    p = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return t, p
    _, test, errstr, _, _ = load_kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = test(o.data_ptr(), d.data_ptr(), tmin.data_ptr(),
                   cid.data_ptr(), te.data_ptr(), bt.data_ptr(),
                   v0.data_ptr(), e1.data_ptr(), e2.data_ptr(),
                   mask.data_ptr(), leaf, n, t.data_ptr(), p.data_ptr(),
                   stream)
    _raise_on(err, "tpt_pair_test", errstr)
    PAIRTEST_LAUNCHES += 1
    return t, p
