"""The device's idle share of a chain of fit steps, in %: 1 - the
device's busy time a chain in the traced chains over the mean chain of
the untraced window (the profiler slows every launch on the host)."""

from perfbench.trace import idle_pct


def read(st):
    return idle_pct(st) if st.kind == "fit" else None
