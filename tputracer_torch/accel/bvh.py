"""Host-side cluster-BVH builder, port of ``tputracer/accel/bvh.py``.

A copy, not an import: importing ``tputracer.accel.bvh`` runs
``tputracer/__init__.py`` and ``tputracer/accel/__init__.py``, which
import JAX.  The code is the JAX package's NumPy code, line for line, so
both packages build the same clusters from the same triangles.

The BVH has two levels: a binary tree over triangle centroids, flattened
at a fixed leaf granularity into C spatially coherent clusters of exactly
``leaf_size`` triangle slots (zero-padded, masked).  The scene tables are
laid out cluster-major, so every cluster is one contiguous slice
``[c * leaf_size, (c + 1) * leaf_size)`` of the triangle tables, which is
what the traversal (accel.clustered, csrc/traverse.cu) walks.

The native binned-SAH builder (accel.native, ``native/bvh_builder.cpp``)
runs when a C++ compiler is there; ``TPUTRACER_NO_NATIVE=1`` forces the
NumPy median-split builder below.  ``LAST_BUILDER`` says which one built
the last scene.
"""

from __future__ import annotations

import os

import numpy as np

# "native" or "numpy": the builder that ran in the last build_clusters call
LAST_BUILDER = None


def pack_clusters(perm, mask, cmin, cmax, src_leaf, dst_leaf,
                  pad_clusters_to=8):
    """Greedy post-pass: pack ADJACENT (DFS-order, so spatially related)
    src_leaf-sized clusters into full dst_leaf-sized ones.  The merged
    AABB is the union of its members' AABBs.  Empty clusters are dropped
    and C is re-padded to ``pad_clusters_to`` with never-hit boxes."""
    Ls, Ld = src_leaf, dst_leaf
    C = cmin.shape[0]
    counts = mask.reshape(C, Ls).sum(axis=1).astype(np.int64)
    groups = []
    cur, cur_n = [], 0
    for c in range(C):
        k = int(counts[c])
        if k == 0:
            continue
        if cur and cur_n + k > Ld:
            groups.append(cur)
            cur, cur_n = [], 0
        cur.append(c)
        cur_n += k
    if cur:
        groups.append(cur)

    Cn = len(groups)
    if pad_clusters_to:
        Cn = -(-Cn // pad_clusters_to) * pad_clusters_to
    nperm = np.zeros((Cn * Ld,), np.int32)
    nmask = np.zeros((Cn * Ld,), np.float32)
    ncmin = np.full((Cn, 3), 3.0e38, np.float32)
    ncmax = np.full((Cn, 3), 3.0e38, np.float32)
    for gi, grp in enumerate(groups):
        ofs = gi * Ld
        ncmin[gi] = np.min(cmin[grp], axis=0)
        ncmax[gi] = np.max(cmax[grp], axis=0)
        for c in grp:
            k = int(counts[c])
            nperm[ofs:ofs + k] = perm[c * Ls:c * Ls + k]
            nmask[ofs:ofs + k] = 1.0
            ofs += k
    return nperm, nmask, ncmin, ncmax


def build_clusters(tv, leaf_size=64, eps=1e-5, pad_clusters_to=8):
    """BVH flattened to fixed-size leaf clusters.

    tv: (T, 3, 3) float32 triangle vertices.
    Returns (perm, pad_mask, clus_min, clus_max):
      perm     (C*leaf_size,) int32: source triangle index per padded slot
               (padding slots repeat index 0 and are masked out)
      pad_mask (C*leaf_size,) float32: 1.0 real / 0.0 padding
      clus_min/clus_max (C, 3) float32: cluster AABBs (eps-padded)

    C is rounded up to ``pad_clusters_to`` with never-hit AABBs, as in
    the JAX package, so both packages give the same C.
    """
    global LAST_BUILDER
    build_leaf = leaf_size

    if not os.environ.get("TPUTRACER_NO_NATIVE"):
        from tputracer_torch.accel.native import build_clusters_native

        out = build_clusters_native(tv, leaf_size=build_leaf, eps=eps,
                                    pad_clusters_to=pad_clusters_to)
        if out is not None:
            LAST_BUILDER = "native"
            return pack_clusters(*out, build_leaf, leaf_size,
                                 pad_clusters_to=pad_clusters_to)

    LAST_BUILDER = "numpy"
    tv = np.asarray(tv, np.float32)
    T = tv.shape[0]
    cent = tv.mean(axis=1)                      # (T,3) centroids

    clusters = []
    stack = [np.arange(T, dtype=np.int64)]
    while stack:
        idx = stack.pop()
        if len(idx) <= build_leaf:
            clusters.append(idx)
            continue
        c = cent[idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        order = np.argsort(c[:, axis], kind="stable")
        half = len(idx) // 2
        stack.append(idx[order[:half]])
        stack.append(idx[order[half:]])

    C = len(clusters)
    if pad_clusters_to:
        C = -(-C // pad_clusters_to) * pad_clusters_to
    L = build_leaf
    perm = np.zeros((C * L,), np.int64)
    mask = np.zeros((C * L,), np.float32)
    # padding clusters: a degenerate box at t ~ 3e38, which the strict
    # (t_enter < tmax) test never admits (an inverted box would not do:
    # the slab test's per-axis min/max un-inverts it)
    cmin = np.full((C, 3), 3.0e38, np.float32)
    cmax = np.full((C, 3), 3.0e38, np.float32)
    for ci, idx in enumerate(clusters):
        k = len(idx)
        perm[ci * L:ci * L + k] = idx
        mask[ci * L:ci * L + k] = 1.0
        pts = tv[idx].reshape(-1, 3)
        ext = eps * max(1.0, float(np.abs(pts).max()))
        cmin[ci] = pts.min(axis=0) - ext
        cmax[ci] = pts.max(axis=0) + ext
    return pack_clusters(perm.astype(np.int32), mask, cmin, cmax,
                         build_leaf, leaf_size,
                         pad_clusters_to=pad_clusters_to)
