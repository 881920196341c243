"""Seconds of the cluster BVH's build in set-up: every untraced record of
the program's ``scene.bvh`` (inside ``make_scene``), summed."""

from perfbench.spans import setup_s


def read(st):
    return setup_s(st, ("scene.bvh",), "render")
