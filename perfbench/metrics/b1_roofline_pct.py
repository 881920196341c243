"""Kernel B1's share of its roofline over its closest-hit launches
(roofline.roofline_pct); None where no traced frame holds B1 launches."""

from perfbench.roofline import roofline_pct


def read(st):
    return roofline_pct(st, "b1") if st.kind == "render" else None
