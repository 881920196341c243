"""The share of a frame's paths still alive in PT's bounces after Russian
roulette first acts: 100 x the mean over rr_start < b <= max_bounces of
``pt.live[b] / pt.lanes`` of each graph replay, the mean over the
window's timed frames."""

from perfbench.pt_bounces import rr_bounces
from perfbench.spans import mean, window


def read(st):
    bounces = rr_bounces(st)
    recs = window(st, "graphs.launch") if bounces else None
    if recs is None:
        return None
    shares = [mean(r.device["pt.live"][b] / r.device["pt.lanes"]
                   for b in bounces)
              for r in recs if r.device and "pt.live" in r.device]
    return 100.0 * mean(shares) if shares else None
