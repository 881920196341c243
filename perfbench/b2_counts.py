"""Kernel B2's tree-walk counters as each graph replay's ``graphs.launch``
record holds them: ``b2.nodes`` (boxes slab-tested), ``b2.visits``
(clusters visited) and ``b2.rays`` (live rays walked), each summed over
the frame's launches, a one-element list (a device tensor's values, as
``trace.device_count`` copies them).  A program older than the counters,
or a scene B2 scans flat, leaves them out, and the readers return
None."""

from __future__ import annotations

from perfbench.spans import window


def per_ray(st, name):
    """Sum of ``name`` over the window's replays over the sum of
    ``b2.rays``; None where no replay counted them."""
    recs = window(st, "graphs.launch") if st.kind == "render" else None
    if recs is None:
        return None
    recs = [r.device for r in recs if r.device and name in r.device]
    rays = sum(_number(r["b2.rays"]) for r in recs)
    return sum(_number(r[name]) for r in recs) / rays if rays else None


def _number(x):
    return sum(x) if isinstance(x, list) else x
