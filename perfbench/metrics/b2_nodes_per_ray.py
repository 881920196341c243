"""Boxes kernel B2's tree walk slab-tests a ray: the sum of the
program's ``b2.nodes`` count over the window's graph replays, over the
sum of ``b2.rays``, the live rays it walked.  None where the records lack
them (the flat scan, or a program without the counters)."""

from perfbench.b2_counts import per_ray


def read(st):
    return per_ray(st, "b2.nodes")
