"""Kernel B2's share of its roofline counted from its visits
(visit_bound.visit_roofline_pct), over the closest-hit launches of the
first traced frame; None where no traced frame holds B2 launches."""

from perfbench.visit_bound import visit_roofline_pct


def read(st):
    return visit_roofline_pct(st) if st.kind == "render" else None
