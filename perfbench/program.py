"""The system under test, ``tputracer_torch``, reached through the entry
points that more than one traffic kind or metric uses: the scene and
camera builders, ``api.render``, the intersection route's hooks and
tables, the launch counters and the graphs' release.  A traffic kind
(``perfbench/kinds/<kind>.py``) calls the entry points of its own
itself.

The program is imported only inside functions, so the harness and the
reference load without it; nothing under ``perfbench/reference/``
imports it.
"""

from __future__ import annotations

import dataclasses
import re

import torch

# the program's hand-written kernels by route, as the trace names them
KERNELS = {"b1": ("fused_intersect_kernel",),
           "b2": ("traverse_kernel",),
           "pairs": ("expand_kernel", "pairtest_kernel", "fold_kernel")}


def route_of(name):
    """The route whose kernel a traced device op's name is, or None."""
    for route, kernels in KERNELS.items():
        for k in kernels:
            if re.search(rf"(?<!\w){k}(?!\w)", name):
                return route
    return None


def build_scene(arrays, config, device):
    """The program's Scene of the benchmark's arrays (``make_scene``: its
    padding, Pluecker tables and, for large meshes, the cluster BVH)."""
    from tputracer_torch.scene.types import make_scene

    s = config["scene"]
    cam = camera(config["camera"], config["camera"]["o"], "cpu")
    return make_scene(arrays.tris, arrays.tri_mat, list(arrays.materials),
                      spheres=list(arrays.spheres), camera=cam,
                      pad_to=s["pad_to"], eps=s["eps"], accel=s["accel"],
                      leaf_size=s["leaf_size"], device=device)


def camera(cam, origin, device):
    """The program's Camera at ``origin``, looking as the configuration
    says (``make_camera``)."""
    from tputracer_torch.scene.types import make_camera

    return make_camera(origin, cam["look_at"], cam["up"], cam["vfov_deg"],
                       cam["aspect"], device=device)


def render_config(render, seed):
    from tputracer_torch.config import RenderConfig

    return RenderConfig(seed=seed, **render)


def with_tables(scene, camera=None, **tables):
    """The scene with another camera and material tables."""
    kw = dict(tables)
    if camera is not None:
        kw["camera"] = camera
    return dataclasses.replace(scene, **kw)


def render(scene, cfg):
    """``api.render``: the frame's (H, W, 3) image on the device."""
    from tputracer_torch import api

    return api.render(scene, cfg)[0]


def recorded_render(scene, cfg, on_closest, on_shadow):
    """An eager ``render_pt`` of the frame through the program's own
    intersection route, with hooks that see each call: on_closest(scene,
    o, d, tmin, tmax, hit) and on_shadow(scene, o, d, tmax, occluded)."""
    from tputracer_torch.accel import intersect, occluded
    from tputracer_torch.integrators.pt import render_pt

    def isect(sc, o, d, tmin, tmax):
        hit = intersect(sc, o, d, tmin, tmax)
        on_closest(sc, o, d, tmin, tmax, hit)
        return hit

    def occl(sc, o, d, tmax):
        occ = occluded(sc, o, d, tmax)
        on_shadow(sc, o, d, tmax, occ)
        return occ

    with torch.no_grad():
        render_pt(scene, cfg, intersect_fn=isect, occluded_fn=occl)


def b1_tables(scene):
    """B1's tables of the scene (sph_c, sph_r, plu, tri_n, tri_v0,
    tri_mask), for counting its work."""
    from tputracer_torch.accel import intersect_cuda

    return intersect_cuda.scene_args(scene)


def b2_tables(scene):
    """B2's tables of the scene (cmin, cmax, plu, trin, v0n, mask)."""
    from tputracer_torch.accel import clustered

    return clustered.traverse_args(scene)


def launch_counts():
    """The program's launch counters, by route."""
    from tputracer_torch.accel import intersect_cuda, pairs_cuda, \
        traverse_cuda

    return {"b1": intersect_cuda.LAUNCHES, "b2": traverse_cuda.LAUNCHES,
            "pairs": pairs_cuda.PAIRTEST_LAUNCHES}


def release():
    """Drop the program's compiled graphs and their memory pool."""
    from tputracer_torch import graphs

    graphs.clear()
