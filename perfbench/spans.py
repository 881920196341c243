"""The program's own spans (``tputracer_torch.trace``) as the per-layer
readers read them.

A span recorded while the profiler runs lands in the program's traced
bin, every other one in its untraced bin.  The measured window runs just
before the traced stretch, so for a span that runs once a frame or a fit
step the last ``len(host["unit_s"]) * steps_per_unit`` untraced records
are exactly the window's frames or steps, free of CUPTI.  A program
without the module (a commit older than it) has no records, and every
reader then returns None.  The program is imported only inside these
functions.
"""

from __future__ import annotations


def records(name):
    """The program's untraced records of span ``name``, oldest first, or
    None where the program keeps no spans."""
    try:
        from tputracer_torch import trace
    except ImportError:
        return None
    return trace.records(name)


def window(st, name):
    """The window's records of span ``name``: the last one a frame or fit
    step of the window; None where fewer were kept."""
    n = len(st.host.get("unit_s") or ()) * st.steps_per_unit
    recs = records(name)
    if not n or recs is None or len(recs) < n:
        return None
    return recs[-n:]


def mean(values):
    values = list(values)
    return sum(values) / len(values) if values else None


def window_ms(st, name, kind):
    """The mean host ms of span ``name`` over the window, in a run of
    ``kind`` ("render" or "fit"); None in another kind's run."""
    recs = window(st, name) if st.kind == kind else None
    return None if recs is None else mean(r.ms for r in recs)


def device_ms(st, name, what):
    """The mean device ms ``what`` over the window's records of span
    ``name`` that have their device times (a render's graph replays)."""
    recs = window(st, name) if st.kind == "render" else None
    if recs is None:
        return None
    return mean(r.device[what] for r in recs if r.device)


def setup_s(st, names, kind, keep=lambda rec: True):
    """The seconds of every untraced record of the spans ``names`` that
    ``keep`` keeps, summed, in a run of ``kind``; None where there is
    none."""
    if st.kind != kind:
        return None
    recs = []
    for name in names:
        recs += [r for r in records(name) or () if keep(r)]
    return sum(r.ms for r in recs) * 1e-3 if recs else None
