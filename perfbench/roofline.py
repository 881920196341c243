"""Kernel rooflines: the least time the card could take for a launch's
work on its own data, over the launch's traced time.

The work counts are a frozen copy of ``chip_smoke.py``'s
``intersect_work``/``intersect_bound``, ``edge_agree`` and
``walk_bound``, with the small helpers they use (the ray features, the
six-term edge volume, the slab entries), so a later change to the
program cannot move the yardstick.  Each multiply and each add counts as
one operation, as the program's sources compute them, and the peak is
the H100 SXM data sheet's 67 TFLOP/s float32 (which counts an FMA as
two): the same work whatever implements it, so no launch can read above
100%.  Memory: 3.35 TB/s.  Both assume the card's full 700 W
(``power.limit`` is printed beside them).
"""

from __future__ import annotations

import torch

PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
BIG = 3.0e38
# float ops of one test, counted from the CUDA sources: a cluster slab
# (6 sub, 6 mul, 12 min/max, 4 compares); a Pluecker + plane triangle test
# (three 6-term dots, 6 sign compares, two 3-term dots, 6 more), of which
# the edge part (the dots and compares) is needed for every pair and the
# plane part only where the three edge signs agree; a sphere test
OPS_SLAB = 26
OPS_PLANE = 56
OPS_EDGES = 39
OPS_SPHERE = 24


def bound_s(ops, nbytes):
    """The least seconds for this work on the card."""
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def ray_features(o, d):
    """[d, o x d] as six (N,) tensors."""
    m = torch.stack([o[:, 1] * d[:, 2] - o[:, 2] * d[:, 1],
                     o[:, 2] * d[:, 0] - o[:, 0] * d[:, 2],
                     o[:, 0] * d[:, 1] - o[:, 1] * d[:, 0]], dim=1)
    return (d[:, 0], d[:, 1], d[:, 2], m[:, 0], m[:, 1], m[:, 2])


def edge_volume(feat, p):
    """sum_k feat[k][:, None] * p[:, k] for a (B, 6) edge table -> (N, B)."""
    w = feat[0][:, None] * p[:, 0]
    for k in range(1, 6):
        w = w + feat[k][:, None] * p[:, k]
    return w


def _agree(w0, w1, w2):
    pos = (w0 >= 0.0) & (w1 >= 0.0) & (w2 >= 0.0)
    neg = (w0 <= 0.0) & (w1 <= 0.0) & (w2 <= 0.0)
    return pos | neg


def intersect_work(o, d, live, args):
    """(ops, bytes) of a closest-hit call of B1 on this data: every live
    ray tests every sphere and runs the edge part of every valid
    triangle's test, and the plane part only where the three edge signs
    agree; each ray's 40 bytes and each table read once."""
    sph_c, plu, mask = args[0], args[2], args[5]
    valid = mask > 0
    feat = ray_features(o[live], d[live])
    agree = 0
    for b0 in range(0, plu.shape[2], 128):
        sl = slice(b0, b0 + 128)
        w = [edge_volume(feat, plu[e, :, sl].T) for e in range(3)]
        agree += int((_agree(*w) & valid[sl]).sum())
    n_live = float(live.sum())
    ops = (n_live * float(valid.sum()) * OPS_EDGES
           + agree * (OPS_PLANE - OPS_EDGES)
           + n_live * sph_c.shape[0] * OPS_SPHERE)
    return ops, 40 * live.numel() + 4 * sum(x.numel() for x in args)


def _safe_inv(d):
    tiny = 1e-12
    return torch.reciprocal(torch.where(
        torch.abs(d) < tiny, torch.where(d >= 0.0, tiny, -tiny), d))


def cluster_entries(o, d, tmin, tmax, cmin, cmax):
    """(N, C) cluster entry distances max(tn, tmin); BIG where the ray's
    (tmin, tmax) window misses the box."""
    inv = _safe_inv(d)[:, None, :]
    t0 = (cmin[None, :, :] - o[:, None, :]) * inv
    t1 = (cmax[None, :, :] - o[:, None, :]) * inv
    tn = torch.amax(torch.minimum(t0, t1), dim=-1)
    tf = torch.amin(torch.maximum(t0, t1), dim=-1)
    hit = (tn <= tf) & (tf > tmin[:, None]) & (tn < tmax[:, None])
    return torch.where(hit, torch.maximum(tn, tmin[:, None]), BIG)


def edge_agree(o, d, c, plu, valid, leaf):
    """How many valid slots of cluster c[i] have ray i's three edge signs
    agree."""
    lane = torch.arange(leaf, device=o.device)
    agree = 0
    for p0 in range(0, c.numel(), 1 << 12):
        ps = slice(p0, p0 + (1 << 12))
        slots = c[ps, None].long() * leaf + lane
        blk = plu[:, :, slots].transpose(1, 2)
        feat = ray_features(o[ps], d[ps])
        w = [edge_volume(feat, blk[e]) for e in range(3)]
        agree += int((_agree(*w) & valid[slots]).sum())
    return agree


def walk_work(o, d, tmin, tmax, t_final, args, leaf):
    """(ops, bytes) of a closest-hit walk of B2 on this data: one slab scan
    of all C boxes per live ray; the edge part of the test for every valid
    slot of each cluster entered before the ray's final hit, and the plane
    part only where the three edge signs agree."""
    cmin, cmax, plu, mask = args[0], args[1], args[2], args[5]
    C, T = cmin.shape[0], plu.shape[2]
    valid_slot = mask > 0
    valid = valid_slot.float().reshape(C, leaf).sum(1)
    live = tmax > tmin
    tests, agree = 0.0, 0
    for r0 in range(0, o.shape[0], 1 << 13):
        rs = slice(r0, r0 + (1 << 13))
        te = cluster_entries(o[rs], d[rs], tmin[rs], tmax[rs], cmin, cmax)
        seen = (te < t_final[rs, None]) & live[rs, None]
        tests += float((seen.float() @ valid).sum())
        ray, c = torch.nonzero(seen, as_tuple=True)
        agree += edge_agree(o[rs][ray], d[rs][ray], c, plu, valid_slot, leaf)
    ops = (float(live.sum()) * C * OPS_SLAB + tests * OPS_EDGES
           + agree * (OPS_PLANE - OPS_EDGES))
    return ops, 4 * (12 * o.shape[0] + 6 * C + 23 * T)


def closest_bounds(stretch, unit, route):
    """The bound in seconds of each closest-hit launch of ``route`` ("b1"
    or "b2") in an eager render of traced frame ``unit``, in launch
    order, with None for each shadow launch: recorded through the
    program's intersection hooks on the frame's own rays."""
    from perfbench import program

    key = ("bounds", route, unit)
    if key in stretch.cache:
        return stretch.cache[key]
    calls = []

    def on_closest(sc, o, d, tmin, tmax, hit):
        if route == "b1":
            ops, nbytes = intersect_work(o, d, tmax > tmin,
                                         program.b1_tables(sc))
        else:
            ops, nbytes = walk_work(o, d, tmin, tmax, hit.t,
                                    program.b2_tables(sc), sc.leaf_size)
        calls.append(bound_s(ops, nbytes))

    def on_shadow(sc, o, d, tmax, occ):
        calls.append(None)

    stretch.replay(unit, on_closest, on_shadow)
    stretch.cache[key] = calls
    return calls


def roofline_pct(stretch, route, frames=2):
    """The share of its roofline that ``route``'s closest-hit launches
    reach: the sum of their bounds over their traced device time, over
    the first ``frames`` traced frames whose trace holds every launch
    the program counted.  None where the stretch has no such frame."""
    from perfbench import program

    bound, spent, used = 0.0, 0.0, 0
    for unit in range(len(stretch.units)):
        if used == frames:
            break
        ops = [op for op in stretch.unit_ops(unit)
               if program.route_of(op[2]) == route]
        if not ops or len(ops) != stretch.counters[unit].get(route):
            continue
        calls = closest_bounds(stretch, unit, route)
        if len(calls) != len(ops):
            continue
        for (s, e, _), b in zip(ops, calls):
            if b is not None:
                bound += b
                spent += (e - s) * 1e-6
        used += 1
    return 100.0 * bound / spent if spent else None
