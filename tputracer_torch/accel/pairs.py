"""Pair-expansion traversal, port of ``tputracer/accel/pairs_tpu.py``.

An opt-in route for clustered scenes (``TPUTRACER_PAIRS=1``, read by
accel.intersect / accel.occluded at call time, CUDA tensors only):

  1. **expand**: each ray gets K slots holding its K nearest admitted
     clusters in (te, c) order, the smaller id first at equal entry, as
     ``(cid, te)`` (``-1``, 3e38 in empty slots), and ``bound``, the entry
     of its (K+1)-th admitted cluster (3e38 if there is none);
  2. **bin**: the N*K slots become (ray, cluster) pairs, stably sorted by
     cluster id; empty slots sort last;
  3. **test and fold**: each pair tests its cluster's ``leaf`` triangle
     slots by Moeller-Trumbore against the ray's initial best ``bt0``
     (never a running best, so the pairs are independent of one another),
     and each ray's K slot results are folded front to back, the first
     strict improvement winning.  On the card one kernel does both: it
     reads the slots through the sort's permutation, and folds with an
     atomic minimum, so the glue makes no gather, scatter or fold;
  4. **resolve**: a closest-hit ray is resolved when its best hit is no
     farther than ``bound``, an any-hit ray when it found a hit or no
     cluster beyond its slots is entered before tmax.  The union-walk
     kernel (accel.traverse_cuda.traverse) then walks every ray from the
     slots' best, the resolved ones at tmax = 0, which it skips.  (Sorting
     the unresolved rays first, as the JAX package does, gives the same
     bits; measured on the card it is slower, PERF.md.)

``expand``/``pairtest`` launch the kernels of ``csrc/pairs.cu`` on CUDA
tensors (accel.pairs_cuda) and run ``expand_plain``/``pairtest_plain`` on
CPU tensors.  There is no other route.  The route makes no host sync.

The JAX package keeps the tables as (3,C)/(3,T) rows; here they are
(C,3)/(T,3), as accel.clustered keeps them.  Traversal is detached.
"""

from __future__ import annotations

import os

import torch

from tputracer_torch.accel.bruteforce import finalize_hit
from tputracer_torch.accel.clustered import (_first_min, _sphere_best,
                                             cluster_entries, traverse_args)
from tputracer_torch.accel.intersect_cuda import _rays
from tputracer_torch.accel.pairs_cuda import expand_cuda, pairtest_cuda
from tputracer_torch.accel.traverse_cuda import traverse

_BIG = 3.0e38
# rows per step of the plain versions, which hold (rows, C) or
# (rows, leaf) temporaries
_EXPAND_ROWS = 1 << 13
_PAIR_ROWS = 1 << 15


def _slots():
    """K, the slots per ray: ``TPUTRACER_PAIRK`` (default 4), at least 2."""
    k = int(os.environ.get("TPUTRACER_PAIRK", "4"))
    if k < 2:
        raise ValueError(f"TPUTRACER_PAIRK={k}: need >= 2 slots")
    return k


K = _slots()


def pairs_args(scene):
    """Scene tables in the kernels' layout, detached and contiguous:
    cmin, cmax (C,3); v0, e1, e2 (T,3); mask (T,)."""
    return tuple(x.detach().contiguous() for x in (
        scene.clus_min, scene.clus_max, scene.tri_v0, scene.tri_e1,
        scene.tri_e2, scene.tri_mask))


def expand_plain(o, d, tmin, tmax, cmin, cmax, k=K):
    """The expand kernel's plain version.

    Returns (cid (N,k) i32, te (N,k) f32, bound (N,) f32): the k smallest
    keys (te, c) among the clusters the ray's window admits, ascending
    (argmin's first-occurrence rule breaks ties on te), -1 and 3e38 in
    empty slots; bound is the (k+1)-th entry or 3e38.  The slab test is
    clustered.cluster_entries, with the window itself required non-empty
    (tmin < tmax): a dead lane whose origin sits inside a box admits
    nothing."""
    cids, tes, bounds = [], [], []
    for r0 in range(0, max(o.shape[0], 1), _EXPAND_ROWS):   # N = 0: one step
        rs = slice(r0, r0 + _EXPAND_ROWS)
        live = (tmin[rs] < tmax[rs])[:, None]
        te = torch.where(live, cluster_entries(o[rs], d[rs], tmin[rs],
                                               tmax[rs], cmin, cmax), _BIG)
        iota = torch.arange(te.shape[1], device=te.device)
        cid_k, te_k = [], []
        for _ in range(k):
            v, c = _first_min(te)
            cid_k.append(torch.where(v < _BIG, c, -1))
            te_k.append(v)
            te = torch.where(iota[None, :] == c[:, None], _BIG, te)
        cids.append(torch.stack(cid_k, dim=1).to(torch.int32))
        tes.append(torch.stack(te_k, dim=1))
        bounds.append(torch.amin(te, dim=1))
    return torch.cat(cids), torch.cat(tes), torch.cat(bounds)


def _mt(o, d, slots, v0, e1, e2):
    """Moeller-Trumbore of each row's ray against its (rows, leaf) triangle
    slots, op for op as tputracer/accel/traverse_tpu.py::mt_cluster_block:
    (|det| > 1e-12, u, v, t), each (rows, leaf)."""
    v0x, v0y, v0z = v0[slots].unbind(-1)
    e1x, e1y, e1z = e1[slots].unbind(-1)
    e2x, e2y, e2z = e2[slots].unbind(-1)
    ox, oy, oz = (x[:, None] for x in o.unbind(1))
    dx, dy, dz = (x[:, None] for x in d.unbind(1))
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = torch.abs(det) > 1e-12
    f = 1.0 / torch.where(ok, det, 1.0)
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    u = f * (sx * px + sy * py + sz * pz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    return ok, u, v, t


def _pair_rows(o, d, tmin, cid, te, bt, v0, e1, e2, mask, leaf):
    """The per-pair test, one (ray, cluster) pair a row: a pair is wanted
    iff te < bt and cid >= 0.  Returns (t (P,) f32, p (P,) i32): the first
    strict minimum of the Moeller-Trumbore hits in cluster cid's leaf slots
    with tmin < t < bt and mask > 0, as (t, cid*leaf + j), or (3e38, -1)
    for a pair that is not wanted or finds no hit."""
    ts, ps = [], []
    lane = torch.arange(leaf, device=o.device)
    for r0 in range(0, max(o.shape[0], 1), _PAIR_ROWS):   # P = 0: one step
        rs = slice(r0, r0 + _PAIR_ROWS)
        c, b = cid[rs], bt[rs]
        want = (te[rs] < b) & (c >= 0)
        base = torch.clamp(c, min=0).long() * leaf
        slots = base[:, None] + lane
        ok, u, v, t = _mt(o[rs], d[rs], slots, v0, e1, e2)
        ok = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
              & (t > tmin[rs, None]) & (t < b[:, None]) & (mask[slots] > 0.0))
        th, j = _first_min(torch.where(ok, t, _BIG))
        hit = want & (th < b)
        ts.append(torch.where(hit, th, _BIG))
        ps.append(torch.where(hit, base + j, -1).to(torch.int32))
    return torch.cat(ts), torch.cat(ps)


def _scatter(idx, src):
    """out[idx] = src for a permutation idx."""
    return torch.empty_like(src).scatter_(0, idx, src)


def pairtest_plain(o, d, tmin, bt0, bp0, sidx, cid, te, v0, e1, e2, mask,
                   leaf):
    """The pair-test kernel's plain version: the per-pair test of every
    slot in the sorted order sidx, then each ray's K slots folded front to
    back from (bt0, bp0), the first strict improvement winning (slots are
    in (te, c) order, so that is the walk's first hit).

    o, d, tmin, bt0, bp0 per ray; sidx (N*K,) the permutation that sorts
    the slots ray*K + k by cluster; cid, te (N,K) in slot order.  Returns
    (best_t (N,) f32, best_p (N,) i32)."""
    n, k = cid.shape
    ray = sidx // k
    pt_, pp_ = _pair_rows(o[ray], d[ray], tmin[ray], cid.reshape(-1)[sidx],
                          te.reshape(-1)[sidx], bt0[ray], v0, e1, e2, mask,
                          leaf)
    t_slots = _scatter(sidx, pt_).reshape(n, k)
    p_slots = _scatter(sidx, pp_).reshape(n, k)
    best_t, best_p = bt0, bp0
    for s in range(k):
        imp = t_slots[:, s] < best_t
        best_t = torch.where(imp, t_slots[:, s], best_t)
        best_p = torch.where(imp, p_slots[:, s], best_p)
    return best_t, best_p


def expand(o, d, tmin, tmax, cmin, cmax, k=K):
    """The expand kernel on a CUDA tensor, its plain version on a CPU one."""
    if o.device.type == "cuda":
        return expand_cuda(o, d, tmin, tmax, cmin, cmax, k=k)
    if o.device.type == "cpu":
        return expand_plain(o, d, tmin, tmax, cmin, cmax, k=k)
    raise ValueError(f"no expand route for device {o.device}")


def pairtest(o, d, tmin, bt0, bp0, sidx, cid, te, v0, e1, e2, mask, leaf):
    """The pair-test kernel on a CUDA tensor, its plain version on a CPU
    one."""
    args = (o, d, tmin, bt0, bp0, sidx, cid, te, v0, e1, e2, mask)
    if o.device.type == "cuda":
        return pairtest_cuda(*args, leaf=leaf)
    if o.device.type == "cpu":
        return pairtest_plain(*args, leaf=leaf)
    raise ValueError(f"no pair-test route for device {o.device}")


def cluster_order(cid, n_clusters):
    """The permutation that stably sorts the slots (cid flattened) by
    cluster, empty slots (-1) last."""
    flat = cid.reshape(-1)
    return torch.sort(torch.where(flat >= 0, flat, n_clusters + 1),
                      stable=True)[1]


def _slot_best(scene, o, d, tmin, tmax, bt0, bp0, any_hit):
    """Expand -> bin -> test and fold: (best_t, best_p, resolved), the best
    hit the K slots give each ray and whether it is final."""
    cmin, cmax, v0, e1, e2, mask = pairs_args(scene)
    cid, tek, bound = expand(o, d, tmin, tmax, cmin, cmax)
    best_t, best_p = pairtest(o, d, tmin, bt0, bp0,
                              cluster_order(cid, scene.n_clusters), cid, tek,
                              v0, e1, e2, mask, scene.leaf_size)
    if any_hit:
        resolved = (best_t < tmax) | (bound >= tmax)
    else:
        resolved = best_t <= bound
    return best_t, best_p, resolved


def _pair_traverse(scene, o, d, tmin, tmax, bt0, bp0, any_hit):
    """The slots' best, then the union-walk kernel from there, with
    tmax = 0 (skipped) for the rays the slots resolve.  Returns (t, prim)
    as accel.clustered._traverse does."""
    best_t, best_p, resolved = _slot_best(scene, o, d, tmin, tmax, bt0, bp0,
                                          any_hit)
    return traverse(o, d, tmin, torch.where(resolved, 0.0, tmax), best_t,
                    best_p, *traverse_args(scene), leaf=scene.leaf_size,
                    any_hit=any_hit)


def rounding_bounds(scene, o, d, prim, t):
    """First-order float32 rounding bounds of a hit at ``t`` on triangle
    slot ``prim`` (prim < scene.n_tri_pad), in float64: (plane, mt).

    ``plane`` bounds the plane test's t = (v0.n - o.n) / d.n, whose
    numerator cancels for origins near the plane; ``mt`` bounds
    Moeller-Trumbore's (the cross products and 3-term dots, 6 eps of their
    absolute sums each, then 1/det and f*num, 2 eps |t|).  The slots of
    this route use Moeller-Trumbore and the walk the plane test, so the
    two routes may place one hit up to about plane + mt apart."""
    eps = 2.0 ** -24
    s = prim.long()
    v0, e1, e2, n = (x[s].double() for x in (scene.tri_v0, scene.tri_e1,
                                             scene.tri_e2, scene.tri_n))
    o, d, t = o.double(), d.double(), t.double().abs()

    def cross_abs(a, b):   # |a_b b_c| + |a_c b_b| per axis
        return torch.stack([(a[:, (k + 1) % 3] * b[:, (k + 2) % 3]).abs()
                            + (a[:, (k + 2) % 3] * b[:, (k + 1) % 3]).abs()
                            for k in range(3)], 1)

    plane = eps * ((o * n).abs().sum(1) + (v0 * n).abs().sum(1)
                   + t * (d * n).abs().sum(1)) / (d * n).sum(1).abs()
    det = (e1 * torch.linalg.cross(d, e2)).sum(1).abs()
    mt = eps * (6.0 * (e2.abs() * cross_abs(o - v0, e1)).sum(1)
                + 6.0 * t * (e1.abs() * cross_abs(d, e2)).sum(1)) / det \
        + eps * 2.0 * t
    return plane, mt


def closest_pairs(scene, o, d, tmin, tmax):
    """(t, prim) of the closest hit through the pair route."""
    od, dd, tn, tx = _rays(o, d, tmin, tmax)
    with torch.no_grad():
        bt0, bp0 = _sphere_best(scene, od, dd, tn, tx)
        return _pair_traverse(scene, od, dd, tn, tx, torch.minimum(bt0, tx),
                              bp0, any_hit=False)


def intersect_pairs(scene, o, d, tmin, tmax):
    """Closest hit through the pair route (Hit SoA)."""
    t, prim = closest_pairs(scene, o, d, tmin, tmax)
    return finalize_hit(scene, o, d, t, prim, t < tmax)


def occluded_pairs(scene, o, d, tmax):
    """Any-hit shadow predicate through the pair route."""
    od, dd, tn, tx = _rays(o, d, torch.zeros_like(tmax), tmax)
    with torch.no_grad():
        bt0, _ = _sphere_best(scene, od, dd, tn, tx)
        bp0 = torch.full(tx.shape, -1, dtype=torch.int32, device=tx.device)
        t, _ = _pair_traverse(scene, od, dd, tn, tx, torch.minimum(bt0, tx),
                              bp0, any_hit=True)
    return t < tx
