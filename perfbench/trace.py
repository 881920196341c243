"""The traced stretch of a run and its reduction to numbers.

A ``--trace 1`` run traces a short steady stretch after its window with
``torch.profiler`` (CPU and CUDA activities): a few frames, or a few
chains of fit steps, each inside a host span of the benchmark's own
(``perfbench.unit``).  :class:`Stretch` holds what the per-layer readers
read: the device operations, the host operations, the units' spans, the
benchmark's own host spans and the program's launch counters per unit.
Times are microseconds on the profiler's clock, host and device alike.
"""

from __future__ import annotations

import bisect
from collections import Counter
from dataclasses import dataclass, field

UNIT = "perfbench.unit"
NAME_CHARS = 200


@dataclass
class Stretch:
    kind: str                       # "render" or "fit"
    steps_per_unit: int             # 1 for a frame, the chain for a fit
    ops: list                       # device ops: (start, end, name), sorted
    host_ops: list                  # host ops: (start, end, name), sorted
    units: list                     # (start, end) of each traced unit
    counters: list                  # launch counts by route, per unit
    host: dict                      # the benchmark's host spans, seconds
    replay: object = None           # replay(unit, on_closest, on_shadow)
    cache: dict = field(default_factory=dict)

    def unit_ops(self, unit):
        """The device ops that start inside unit ``unit``'s host span."""
        if "starts" not in self.cache:
            self.cache["starts"] = [op[0] for op in self.ops]
        starts = self.cache["starts"]
        s, e = self.units[unit]
        return self.ops[bisect.bisect_left(starts, s):
                        bisect.bisect_right(starts, e)]

    def span_us(self):
        return self.units[-1][1] - self.units[0][0]

    def busy_us(self):
        return union_us(self.ops, *self.window())

    def window(self):
        return self.units[0][0], self.units[-1][1]


def is_kernel(name):
    return not name.startswith(("Memcpy", "Memset"))


def union_us(ops, lo=None, hi=None):
    """Microseconds in which at least one of ``ops`` ran, clipped to
    [lo, hi]: the union of their intervals."""
    total, end = 0.0, None
    for s, e, _ in ops:
        if lo is not None:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
        if end is None or s >= end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def idle_pct(st):
    """1 - the device's busy time a unit in the traced stretch over the
    mean unit of the untraced window (``host["unit_s"]``), in %; None
    with no traced unit or no window."""
    window = st.host.get("unit_s")
    if not st.units or not window:
        return None
    busy_s = st.busy_us() * 1e-6 / len(st.units)
    return 100.0 * (1.0 - busy_s * len(window) / sum(window))


def gaps(ops, lo, hi):
    """The idle intervals between the device ops' union, inside [lo, hi]."""
    out, end = [], lo
    for s, e, _ in ops:
        if e <= lo or s >= hi:
            continue
        if s > end:
            out.append((end, s))
        end = max(end, e)
    if hi > end:
        out.append((end, hi))
    return out


def from_profiler(prof, kind, steps_per_unit, counters, host, replay=None):
    """A Stretch from a finished ``torch.profiler.profile``."""
    import torch

    ops, host_ops, units = [], [], []
    for ev in prof.events():
        s, e = float(ev.time_range.start), float(ev.time_range.end)
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            ops.append((s, e, ev.name))
        elif ev.name == UNIT:
            units.append((s, e))
        else:
            host_ops.append((s, e, ev.name))
    # a host range (record_function: the benchmark's units, the
    # optimizer's step) is also drawn on the device's timeline; it is no
    # device op
    ranges = {n for _, _, n in host_ops} | {UNIT}
    ops = [op for op in ops if op[2] not in ranges]
    ops.sort()
    host_ops.sort()
    units.sort()
    return Stretch(kind, steps_per_unit, ops, host_ops, units, counters,
                   host, replay)


def mode(values):
    """The most common value (the largest among equals)."""
    counts = Counter(values)
    top = max(counts.values())
    return max(v for v, c in counts.items() if c == top)


def breakdown(st, top=10):
    """The device ops that took most time, and the longest idle time by
    what the host was doing then (the innermost host op around the gap's
    middle), summed over the traced stretch: at most ``top`` of each, as
    [name, seconds], each name cut to ``NAME_CHARS``."""
    lo, hi = st.window()
    by_op = Counter()
    for s, e, name in st.ops:
        if lo <= s <= hi:
            by_op[name] += (e - s) * 1e-6
    starts = [h[0] for h in st.host_ops]
    by_host = Counter()
    for g0, g1 in gaps(st.ops, lo, hi):
        mid = 0.5 * (g0 + g1)
        best = None
        for i in range(bisect.bisect_right(starts, mid) - 1,
                       max(-1, bisect.bisect_right(starts, mid) - 400), -1):
            s, e, name = st.host_ops[i]
            if e >= mid and (best is None or e - s < best[1] - best[0]):
                best = (s, e, name)
        by_host[best[2] if best else "no host op"] += (g1 - g0) * 1e-6
    return {"device_ops": [[n[:NAME_CHARS], v]
                           for n, v in by_op.most_common(top)],
            "idle_gaps": [[n[:NAME_CHARS], v]
                          for n, v in by_host.most_common(top)]}
