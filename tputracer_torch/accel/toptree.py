"""The top level of the cluster BVH: one box over each run of clusters.

Kernel B2 (``csrc/traverse.cu``) stages every box it scans in one block's
shared memory.  Up to ``tpt_traverse_max_clusters()`` clusters (9,685 on
Hopper) it scans the cluster boxes themselves; above that it walks this
level first: top node g covers clusters [g * FANOUT, (g + 1) * FANOUT),
consecutive in the builder's order (so spatially close), and its box is
the exact float32 min and max of its children's boxes.

Every rounding in the slab test is monotone, so a ray's entry into a
node's box is at most its entry into any child's, and a node is admitted
wherever a child is.  A walk that opens a node no later than the first
of its children it would visit therefore visits the clusters in the flat
walk's (te, c) order, whatever the grouping; the grouping only decides
how much work the walk saves.
"""

from __future__ import annotations

import torch

# clusters under one top node: the lanes of the warp that walks a ray
# test one child each
FANOUT = 32


def top_boxes(cmin, cmax):
    """(top_min, top_max), each (ceil(C / FANOUT), 3) float32 on the boxes'
    device: node g's box is the exact min and max of clusters
    g * FANOUT .. min((g + 1) * FANOUT, C) - 1."""
    C = cmin.shape[0]
    G = -(-C // FANOUT)
    if C == 0:
        return cmin[:0].clone(), cmax[:0].clone()
    pad = G * FANOUT - C
    # the last node's missing children repeat its last cluster, which
    # leaves its min and max as they are
    lo = torch.cat([cmin, cmin[-1:].expand(pad, 3)]).reshape(G, FANOUT, 3)
    hi = torch.cat([cmax, cmax[-1:].expand(pad, 3)]).reshape(G, FANOUT, 3)
    return lo.amin(dim=1).contiguous(), hi.amax(dim=1).contiguous()
