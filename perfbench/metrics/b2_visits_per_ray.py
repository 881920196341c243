"""Clusters kernel B2's tree walk visits a ray: the sum of the program's
``b2.visits`` count over the window's graph replays, over the sum of
``b2.rays``.  None where the records lack them."""

from perfbench.b2_counts import per_ray


def read(st):
    return per_ray(st, "b2.visits")
