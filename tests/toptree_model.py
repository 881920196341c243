"""A step-by-step model of kernel B2's tree walk (``csrc/traverse.cu``,
``tree::traverse_kernel``), one ray at a time, for the tests.

It keeps what the kernel's warp keeps: each of the 32 lanes' sorted
buffer of its 4 smallest node keys (with the rescan when it runs dry),
its sorted buffer of 4 pending cluster keys, its watermark (the least
key pushed out of that buffer), the last opened node and the last
visited cluster; and it takes the same step the kernel takes from them
(refill, open, visit or end).  So it gives the kernel's visit order, its
(t, prim) and its counters (boxes slab-tested, clusters visited, rays
walked) exactly.  The slab entries are ``clustered.cluster_entries`` and
a visit is ``clustered._tri_block``, the plain walk's own arithmetic.

:func:`flat_walk` is the plain walk by its definition: the admitted
clusters in (te, c) order while te < best_t.  The CPU tests hold the
model's visit order to it and its (t, prim) to ``clustered._traverse``;
the card's tests hold the kernel's counters to the model's.
"""

from __future__ import annotations

import collections
import math

import torch

from tputracer_torch.accel import clustered as cl
from tputracer_torch.accel.bruteforce import ray_features
from tputracer_torch.accel.toptree import FANOUT

LANES = 32       # a warp walks a ray
KBUF = 4         # keys a lane's buffer holds
INF = math.inf
NONE = 0x7FFFFFFF
NO_KEY = (INF, NONE)


def _entries(o, d, tmin, tmax, lo, hi):
    """A ray's entry into each box, as floats; inf where not admitted."""
    te = cl.cluster_entries(o[None], d[None], tmin[None], tmax[None], lo,
                            hi)[0]
    return [INF if x >= cl._BIG else x for x in te.tolist()]


class _Ray:
    """One ray's tables and its visits (clustered._tri_block)."""

    def __init__(self, i, walk_in, tables, leaf):
        o, d, tmin, tmax, bt0, bp0 = walk_in
        self.o, self.d = o[i:i + 1], d[i:i + 1]
        self.tmin, self.tmax = tmin[i:i + 1], tmax[i:i + 1]
        self.best_t, self.best_p = float(bt0[i]), int(bp0[i])
        self.tables, self.leaf = tables, leaf
        self.live = bool(tmax[i] > tmin[i])
        self.visits = []

    def entries(self, lo, hi):
        return _entries(self.o[0], self.d[0], self.tmin[0], self.tmax[0],
                        lo, hi)

    def visit(self, c):
        """Visit cluster c: whether it gave a nearer hit."""
        self.visits.append(c)
        plu, trin, v0n, mask = self.tables[2:6]
        bt = torch.tensor([self.best_t], dtype=torch.float32)
        t, j = cl._tri_block(ray_features(self.o, self.d), self.o, self.d,
                             self.tmin, bt, torch.tensor([c]), plu, trin,
                             v0n, mask, self.leaf)
        if float(t[0]) < self.best_t:
            self.best_t = float(t[0])
            self.best_p = c * self.leaf + int(j[0])
            return True
        return False


def flat_walk(i, walk_in, tables, leaf, any_hit=False):
    """Ray i by the plain walk's definition: (t, prim, visit order)."""
    ray = _Ray(i, walk_in, tables, leaf)
    if ray.live:
        te = ray.entries(tables[0], tables[1])
        for t, c in sorted((t, c) for c, t in enumerate(te) if t < INF):
            if not t < ray.best_t:
                break
            if ray.visit(c) and any_hit:
                break
    return ray.best_t, ray.best_p, ray.visits


def tree_walk(i, walk_in, tables, leaf, any_hit=False, events=None):
    """Ray i as the kernel's tree walk takes it, over the top level in
    ``tables`` (clustered.traverse_args): (t, prim, visit order, counts
    (boxes slab-tested, clusters visited, rays walked)).
    ``events``, a Counter, counts its "refill" and "rescan" steps."""
    events = collections.Counter() if events is None else events
    ray = _Ray(i, walk_in, tables, leaf)
    if not ray.live:
        return ray.best_t, ray.best_p, [], (0, 0, 0)
    C, NG = tables[0].shape[0], tables[6].shape[0]
    node_te = ray.entries(tables[6], tables[7])
    clus_te = ray.entries(tables[0], tables[1])
    boxes = 0

    def scan(lane, last):
        # the lane's kBuf smallest node keys after `last`, and whether
        # there were more
        nonlocal boxes
        mine = range(lane, NG, LANES)
        boxes += len(mine)
        keys = sorted((node_te[j], j) for j in mine
                      if node_te[j] < ray.best_t and last < (node_te[j], j))
        return keys[:KBUF], len(keys) > KBUF

    nodes = [scan(lane, (-cl._BIG, -1)) for lane in range(LANES)]
    nbuf = [keys for keys, _ in nodes]
    nmore = [more for _, more in nodes]
    cbuf = [[] for _ in range(LANES)]
    water = [NO_KEY] * LANES
    last_node, last_clus = (-cl._BIG, -1), (-cl._BIG, -1)

    def head(buf):
        return buf[0] if buf else NO_KEY

    def push_children(node):
        # lane l slab-tests cluster node * FANOUT + l and pushes its key;
        # the key carried out of a full buffer lowers the watermark
        nonlocal boxes
        for lane in range(LANES):
            k = node * FANOUT + lane
            if k >= C:
                continue
            boxes += 1
            key = (clus_te[k], k)
            if key[0] < ray.best_t and last_clus < key:
                buf = sorted(cbuf[lane] + [key])
                out = buf.pop() if len(buf) > KBUF else NO_KEY
                cbuf[lane] = buf
                water[lane] = min(water[lane], out)

    tg = min(head(b) for b in nbuf)
    while True:
        tc = min(head(b) for b in cbuf)
        tw = min(water)
        if not tc < tw:
            if tw[0] < ray.best_t:    # refill from the opened nodes
                events["refill"] += 1
                cbuf = [[] for _ in range(LANES)]
                water = [NO_KEY] * LANES
                for j0 in range(0, NG, LANES):
                    opened = []
                    for j in range(j0, min(j0 + LANES, NG)):
                        boxes += 1
                        if node_te[j] < ray.best_t and \
                                not last_node < (node_te[j], j):
                            opened.append(j)
                    for j in opened:
                        push_children(j)
                continue
            tc = NO_KEY
        if tg[0] < ray.best_t and not tc[0] < tg[0]:    # open node tg
            g = tg[1]
            owner = g % LANES
            assert nbuf[owner][0] == tg
            nbuf[owner] = nbuf[owner][1:]
            if not nbuf[owner] and nmore[owner]:
                events["rescan"] += 1
                nbuf[owner], nmore[owner] = scan(owner, tg)
            last_node = tg
            push_children(g)
            tg = min(head(b) for b in nbuf)
            continue
        if not tc[0] < ray.best_t:
            break
        c = tc[1]
        hit = ray.visit(c)
        if hit and any_hit:
            break
        owner = c % LANES
        assert cbuf[owner][0] == tc
        cbuf[owner] = cbuf[owner][1:]
        last_clus = tc
    return ray.best_t, ray.best_p, ray.visits, (boxes, len(ray.visits), 1)


def tree_counts(walk_in, tables, leaf, any_hit=False):
    """The tree walk's counts summed over every ray of ``walk_in``."""
    total = [0, 0, 0]
    for i in range(walk_in[0].shape[0]):
        for k, v in enumerate(tree_walk(i, walk_in, tables, leaf,
                                        any_hit)[3]):
            total[k] += v
    return total
