"""Kernel B2's roofline counted from its visits, for walks that do not
scan every cluster box.

``roofline.walk_work`` charges each live ray one slab test of all C
cluster boxes: the flat scan's work.  A walk that reaches the clusters
through a tree tests far fewer boxes, and against that count it would
read above 100%.  This count holds for any walk that visits the clusters
in (te, c) order, whatever finds them, so no launch can read above 100%:

  * for each live ray, one slab test of each cluster it enters before
    its final hit (te < t_final): the clusters any such walk visits;
  * the edge part of the triangle test for every valid slot of those
    clusters, and the plane part where the three edge signs agree;
  * bytes: each ray's 48 (o, d) once, and each distinct cluster the
    launch visits read once, its box (24) and its slots' 23 floats
    (Pluecker 18, normal 3, v0.n, mask): 4 (12 N + 6 V + 23 leaf V).

The work is recorded on the frame's own rays through the run's replay
(``stretch.replay``), as ``roofline.closest_bounds`` records its own,
over the B2 launches of the first traced frame that holds every launch
the program counted.
"""

from __future__ import annotations

import torch

from perfbench.roofline import (OPS_EDGES, OPS_PLANE, OPS_SLAB, bound_s,
                                cluster_entries, edge_agree)

# rays a block of the entry test: (rays, C, 3) floats at C = 18,304
RAY_BLOCK = 1 << 11


def visit_work(o, d, tmin, tmax, t_final, args, leaf):
    """(ops, bytes) of a closest-hit launch of B2 on this data, counted
    from the clusters its rays enter before their final hits."""
    cmin, cmax, plu, mask = args[0], args[1], args[2], args[5]
    C = cmin.shape[0]
    valid_slot = mask > 0
    valid = valid_slot.float().reshape(C, leaf).sum(1)
    live = tmax > tmin
    slabs, tests, agree = 0.0, 0.0, 0
    visited = torch.zeros(C, dtype=torch.bool, device=o.device)
    for r0 in range(0, o.shape[0], RAY_BLOCK):
        rs = slice(r0, r0 + RAY_BLOCK)
        te = cluster_entries(o[rs], d[rs], tmin[rs], tmax[rs], cmin, cmax)
        seen = (te < t_final[rs, None]) & live[rs, None]
        slabs += float(seen.sum())
        tests += float((seen.float() @ valid).sum())
        visited |= seen.any(0)
        ray, c = torch.nonzero(seen, as_tuple=True)
        agree += edge_agree(o[rs][ray], d[rs][ray], c, plu, valid_slot, leaf)
    V = float(visited.sum())
    ops = (slabs * OPS_SLAB + tests * OPS_EDGES
           + agree * (OPS_PLANE - OPS_EDGES))
    return ops, 4 * (12 * o.shape[0] + 6 * V + 23 * leaf * V)


def closest_visit_bounds(stretch, unit):
    """The visit bound in seconds of each closest-hit B2 launch in an
    eager render of traced frame ``unit``, in launch order, with None for
    each shadow launch."""
    from perfbench import program

    key = ("visit_bounds", unit)
    if key in stretch.cache:
        return stretch.cache[key]
    calls = []

    def on_closest(sc, o, d, tmin, tmax, hit):
        calls.append(bound_s(*visit_work(o, d, tmin, tmax, hit.t,
                                         program.b2_tables(sc),
                                         sc.leaf_size)))

    def on_shadow(sc, o, d, tmax, occ):
        calls.append(None)

    stretch.replay(unit, on_closest, on_shadow)
    stretch.cache[key] = calls
    return calls


def visit_roofline_pct(stretch):
    """The share of the visit bound that B2's closest-hit launches reach
    over their traced device time, in the first traced frame whose trace
    holds every B2 launch the program counted; None where none does."""
    from perfbench import program

    for unit in range(len(stretch.units)):
        ops = [op for op in stretch.unit_ops(unit)
               if program.route_of(op[2]) == "b2"]
        if not ops or len(ops) != stretch.counters[unit].get("b2"):
            continue
        calls = closest_visit_bounds(stretch, unit)
        if len(calls) != len(ops):
            continue
        bound = sum(b for b in calls if b is not None)
        spent = sum((e - s) * 1e-6 for (s, e, _), b in zip(ops, calls)
                    if b is not None)
        return 100.0 * bound / spent if spent else None
    return None
