"""Seconds of the program's ``make_scene`` in set-up (its padding,
Pluecker tables and cluster BVH), from the benchmark's span around it."""


def read(st):
    spans = st.host.get("scene_build")
    return spans[0] if spans else None
