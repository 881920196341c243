"""The device's idle share of a frame, in %: 1 - the device's busy time
a frame in the traced frames (the union of the device ops' intervals
over their number) over the mean frame of the untraced window.  The
traced frames' own wall span would count the profiler: its CUPTI tracing
slows each graph launch on the host several times over."""

from perfbench.trace import idle_pct


def read(st):
    return idle_pct(st) if st.kind == "render" else None
