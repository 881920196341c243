"""Kernel B2's share of its roofline over its closest-hit launches
(roofline.roofline_pct); None where no traced frame holds B2 launches."""

from perfbench.roofline import roofline_pct


def read(st):
    return roofline_pct(st, "b2", frames=1) if st.kind == "render" else None
