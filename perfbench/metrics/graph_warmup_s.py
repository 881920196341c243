"""Seconds of set-up in the graphs' warm-up: every untraced record of the
program's ``graphs.eager`` (a key's first, eager call; calls that are
never graphed left out) and ``graphs.capture``, summed."""

from perfbench.spans import setup_s


def read(st):
    return setup_s(st, ("graphs.eager", "graphs.capture"), "render",
                   lambda r: not r.counts.get("ungraphed"))
