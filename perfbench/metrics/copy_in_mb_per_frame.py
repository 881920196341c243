"""MB a frame copied into the graph's static inputs: the mean of the
``bytes`` count of the program's ``graphs.copy_in`` over the window's
frames, over 1e6."""

from perfbench.spans import mean, window


def read(st):
    recs = window(st, "graphs.copy_in") if st.kind == "render" else None
    return None if recs is None else mean(
        r.counts["bytes"] for r in recs) / 1e6
