"""Cluster-BVH traversal in plain torch, port of ``tputracer/accel/clustered.py``.

The walk over the 2-level cluster BVH (accel.bvh), for each ray:

  1. a slab test against ALL cluster AABBs gives an entry distance per
     cluster (``cluster_entries``);
  2. the admitted clusters are visited front to back: the next one is the
     lexicographically smallest (t_enter, cluster id) strictly greater
     than the last visited, among those entered before the current best
     hit.  A visit tests the cluster's ``leaf`` triangle slots, one
     contiguous block of the cluster-major tables, with the Pluecker edge
     signs and the plane equation (accel.bruteforce); the first strict
     minimum wins, and replaces the best only if it is nearer;
  3. the walk ends when no admitted cluster is entered before the best
     hit; with any_hit, a lane also stops at its first hit.

``_traverse`` takes the CUDA kernel's argument list (accel.traverse_cuda,
csrc/traverse.cu) and is its plain version: it is the CPU route for
clustered scenes and the oracle the kernel is held to on the card.  The
volumes are summed term by term in a fixed order (edge_volume), as the
kernel sums them, so the two agree bit for bit.

Two departures from the JAX walk, neither of which changes a closest hit
or an occlusion verdict:

  * the ``lax.while_loop`` over all lanes becomes a Python loop over the
    lanes still walking, which are gathered anew each step (one host
    sync per step; this version is never on the card's main path);
  * with any_hit a lane stops at its first hit.  The JAX loop keeps such
    a lane walking while other lanes walk, so the t it returns depends on
    the batch; ``t < tmax`` does not.

Traversal is detached: (t, prim) depend on geometry only, never on the
differentiable material and light tables.
"""

from __future__ import annotations

import torch

from tputracer_torch import geometry as g
from tputracer_torch.accel.bruteforce import (_sph_candidates, edge_volume,
                                              finalize_hit, ray_features)
from tputracer_torch.accel.intersect_cuda import _rays

_BIG = 3.0e38


def traverse_args(scene):
    """Scene tables in the kernel's layout, detached and contiguous:
    cmin, cmax (C,3); plu (3,6,T), the scene's own layout; trin (T,3);
    v0n (T,) = v0.n; mask (T,); top_min, top_max (G,3), the top level
    over the cluster boxes (accel.toptree), which only the kernel's tree
    walk reads.  Only v0n is computed; the scene's tables are contiguous,
    so the rest are the scene's own tensors."""
    return (scene.clus_min.detach().contiguous(),
            scene.clus_max.detach().contiguous(),
            scene.plu.detach().contiguous(),
            scene.tri_n.detach().contiguous(),
            g.dot(scene.tri_v0, scene.tri_n).detach().contiguous(),
            scene.tri_mask.detach().contiguous(),
            scene.top_min.detach().contiguous(),
            scene.top_max.detach().contiguous())


def _safe_inv(d):
    """1/d with a signed clamp at 1e-12: degenerate axes give +-1e12
    slabs, which the min/max slab arithmetic handles."""
    tiny = 1e-12
    return torch.reciprocal(torch.where(
        torch.abs(d) < tiny, torch.where(d >= 0.0, tiny, -tiny), d))


def cluster_entries(o, d, tmin, tmax, cmin, cmax):
    """(N, C) cluster entry distances max(tn, tmin); _BIG where the ray's
    (tmin, tmax) window misses the AABB."""
    inv = _safe_inv(d)[:, None, :]
    t0 = (cmin[None, :, :] - o[:, None, :]) * inv
    t1 = (cmax[None, :, :] - o[:, None, :]) * inv
    tn = torch.amax(torch.minimum(t0, t1), dim=-1)
    tf = torch.amin(torch.maximum(t0, t1), dim=-1)
    hit = (tn <= tf) & (tf > tmin[:, None]) & (tn < tmax[:, None])
    return torch.where(hit, torch.maximum(tn, tmin[:, None]), _BIG)


def _first_min(x):
    """(min, index of its first occurrence) along dim 1.  Written out, not
    left to torch.min's tie rule: the walk's order depends on it."""
    v = torch.amin(x, dim=1)
    iota = torch.arange(x.shape[1], device=x.device)
    return v, torch.amin(torch.where(x == v[:, None], iota, x.shape[1]),
                         dim=1)


def _tri_block(feat, o, d, tmin, best_t, cid, plu, trin, v0n, mask, leaf):
    """Nearest hit of each ray in its cluster cid's triangle block.

    feat: six (n,) ray features; cid: (n,) cluster ids.  Returns
    (t (n,), j (n,)): the first strict minimum over the slots whose
    candidate passes tmin < t < best_t, or (_BIG, 0) if none does."""
    slots = cid[:, None].long() * leaf + torch.arange(leaf, device=cid.device)
    blk = plu[:, :, slots].transpose(1, 2)         # (3, n, 6, L)
    w0, w1, w2 = (edge_volume(feat, blk[e]) for e in range(3))
    pos = (w0 >= 0.0) & (w1 >= 0.0) & (w2 >= 0.0)
    neg = (w0 <= 0.0) & (w1 <= 0.0) & (w2 <= 0.0)
    nx, ny, nz = trin[slots].unbind(-1)            # (n, L) each
    dx, dy, dz = (x[:, None] for x in d.unbind(1))
    ox, oy, oz = (x[:, None] for x in o.unbind(1))
    d_dot_n = dx * nx + dy * ny + dz * nz
    o_dot_n = ox * nx + oy * ny + oz * nz
    ok = torch.abs(d_dot_n) > 1e-12
    t = (v0n[slots] - o_dot_n) / torch.where(ok, d_dot_n, 1.0)
    ok = (ok & (pos | neg) & (t > tmin[:, None]) & (t < best_t[:, None])
          & (mask[slots] > 0.0))
    return _first_min(torch.where(ok, t, _BIG))


def _traverse(o, d, tmin, tmax, bt0, bp0, cmin, cmax, plu, trin, v0n, mask,
              top_min, top_max, leaf, any_hit=False):
    """Front-to-back cluster walk, the kernel's plain version.

    Returns (t (N,) f32, prim (N,) i32): the closest triangle hit with
    tmin < t < bt0 as (t, slot index c*leaf + j), else (bt0, bp0).  Lanes
    with tmax <= tmin are not walked.  The top level (top_min, top_max)
    only guides the kernel's tree walk, so this walk does not read it."""
    best_t, best_p = bt0.clone(), bp0.clone()
    te_all = cluster_entries(o, d, tmin, tmax, cmin, cmax)
    c_iota = torch.arange(cmin.shape[0], device=o.device)[None, :]
    lane = torch.nonzero(tmax > tmin).squeeze(1)   # lanes still walking
    t_last = torch.full(lane.shape, -_BIG, device=o.device)
    c_last = torch.full(lane.shape, -1, dtype=torch.long, device=o.device)
    while lane.numel():
        te, bt = te_all[lane], best_t[lane]
        after = (te > t_last[:, None]) | (
            (te == t_last[:, None]) & (c_iota > c_last[:, None]))
        score = torch.where(after & (te < bt[:, None]), te, _BIG)
        t_next, cid = _first_min(score)
        active = t_next < _BIG
        ol, dl = o[lane], d[lane]
        t_hit, j = _tri_block(ray_features(ol, dl), ol, dl, tmin[lane], bt,
                              cid, plu, trin, v0n, mask, leaf)
        imp = active & (t_hit < bt)
        best_t[lane] = torch.where(imp, t_hit, bt)
        best_p[lane] = torch.where(imp, (cid * leaf + j).to(torch.int32),
                                   best_p[lane])
        go = active & ~imp if any_hit else active
        lane, t_last, c_last = lane[go], t_next[go], cid[go]
    return best_t, best_p


def _sphere_best(scene, o, d, tmin, tmax):
    """Nearest sphere hit, the walk's initial best (S is tiny)."""
    n = o.shape[0]
    if not scene.n_spheres:
        return (torch.full((n,), _BIG, device=o.device),
                torch.full((n,), -1, dtype=torch.int32, device=o.device))
    ts, sv = _sph_candidates(scene, o, d, tmin, tmax)
    t, j = _first_min(torch.where(sv, ts, _BIG))
    prim = torch.where(t < _BIG, scene.n_tri_pad + j, -1).to(torch.int32)
    return t, prim


def closest_clustered(scene, o, d, tmin, tmax, walk=_traverse):
    """(t, prim) of the closest hit through the cluster BVH.  ``walk`` is
    ``_traverse`` or a function with its arguments (the CUDA kernel's
    wrapper, accel.traverse_cuda.traverse)."""
    od, dd, tn, tx = _rays(o, d, tmin, tmax)
    with torch.no_grad():
        bt0, bp0 = _sphere_best(scene, od, dd, tn, tx)
        return walk(od, dd, tn, tx, torch.minimum(bt0, tx), bp0,
                    *traverse_args(scene), leaf=scene.leaf_size,
                    any_hit=False)


def intersect_clustered(scene, o, d, tmin, tmax, walk=_traverse):
    """Closest hit through the cluster BVH; same Hit SoA as brute force
    (``walk`` as in :func:`closest_clustered`)."""
    t, prim = closest_clustered(scene, o, d, tmin, tmax, walk=walk)
    return finalize_hit(scene, o, d, t, prim, t < tmax)


def occluded_clustered(scene, o, d, tmax, walk=_traverse):
    """Any-hit predicate for shadow rays through the cluster BVH."""
    od, dd, tn, tx = _rays(o, d, torch.zeros_like(tmax), tmax)
    with torch.no_grad():
        bt0, _ = _sphere_best(scene, od, dd, tn, tx)
        bp0 = torch.full(tx.shape, -1, dtype=torch.int32, device=tx.device)
        t, _ = walk(od, dd, tn, tx, torch.minimum(bt0, tx), bp0,
                    *traverse_args(scene), leaf=scene.leaf_size, any_hit=True)
    return t < tx
