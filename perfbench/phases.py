"""The device time of the program's phases inside a graph replay: a
``tputracer_torch.trace.phase`` that ran while a CUDA graph was captured
times its work at each replay, and the replay's ``graphs.launch`` record
holds its device ms under the phase's name, summed over the frame."""

from __future__ import annotations

from perfbench.spans import device_ms


def device_ms_sum(st, names):
    """The window's mean device ms a frame of the phases ``names``,
    summed; None where the program does not time them (a program older
    than its phases, whose replays' records lack the names)."""
    try:
        parts = [device_ms(st, "graphs.launch", name) for name in names]
    except KeyError:
        return None
    return None if None in parts else sum(parts)
