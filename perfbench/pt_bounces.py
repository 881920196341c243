"""PT's bounces after Russian roulette has first culled lanes, as the
program's graph replays time and count them: each bounce b of a chunk is
the phase ``pt.bounce.<b>``, and a replay's ``graphs.launch`` record
holds the frame's closest-hit rays per bounce, summed over its chunks
(``pt.live``, a list), and its path count (``pt.lanes``).  A program
older than these (the records lack the names) reads None."""

from __future__ import annotations


def rr_bounces(st):
    """The bounces b with rr_start < b <= max_bounces of the run's render
    traffic, whose traffic the stretch's ``replay`` (a bound method of the
    run) carries; None for a run without Russian roulette."""
    run = getattr(st.replay, "__self__", None)
    r = getattr(run, "traffic", {}).get("render", {})
    if st.kind != "render" or "rr_start" not in r:
        return None
    return range(r["rr_start"] + 1, r["max_bounces"] + 1)
