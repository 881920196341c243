"""Procedural Cornell-box scenes, port of ``tputracer/scene/cornell.py``.

The classic 555-unit Cornell box scaled into [0,1]^3, built with the same
NumPy code as the JAX package so both produce identical arrays.
"""

from __future__ import annotations

import numpy as np

from tputracer_torch.scene.types import (
    DIFFUSE,
    GLASS,
    MIRROR,
    make_camera,
    make_scene,
)

# material table shared by all cornell variants
MAT_WHITE = 0
MAT_RED = 1
MAT_GREEN = 2
MAT_LIGHT = 3
MAT_MIRROR = 4
MAT_GLASS = 5

_MATERIALS = [
    {"kind": DIFFUSE, "albedo": (0.73, 0.73, 0.73)},
    {"kind": DIFFUSE, "albedo": (0.65, 0.05, 0.05)},
    {"kind": DIFFUSE, "albedo": (0.12, 0.45, 0.15)},
    {"kind": DIFFUSE, "albedo": (0.0, 0.0, 0.0), "emission": (18.4, 15.6, 8.0)},
    {"kind": MIRROR, "albedo": (0.95, 0.95, 0.95)},
    {"kind": GLASS, "albedo": (1.0, 1.0, 1.0), "ior": 1.5},
]


def quad(p0, p1, p2, p3):
    """Two triangles for quad p0-p1-p2-p3 (vertices in order around the quad)."""
    p0, p1, p2, p3 = (np.asarray(p, np.float32) for p in (p0, p1, p2, p3))
    return [np.stack([p0, p1, p2]), np.stack([p0, p2, p3])]


def _box(lo, hi):
    """Axis-aligned box as 12 triangles (all 6 faces)."""
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    tris = []
    tris += quad((x0, y0, z0), (x1, y0, z0), (x1, y1, z0), (x0, y1, z0))  # z0
    tris += quad((x0, y0, z1), (x0, y1, z1), (x1, y1, z1), (x1, y0, z1))  # z1
    tris += quad((x0, y0, z0), (x0, y1, z0), (x0, y1, z1), (x0, y0, z1))  # x0
    tris += quad((x1, y0, z0), (x1, y0, z1), (x1, y1, z1), (x1, y1, z0))  # x1
    tris += quad((x0, y0, z0), (x0, y0, z1), (x1, y0, z1), (x1, y0, z0))  # y0
    tris += quad((x0, y1, z0), (x1, y1, z0), (x1, y1, z1), (x0, y1, z1))  # y1
    return tris


def cornell_box(variant="boxes", aspect=1.0, light_scale=1.0, pad_to=128,
                accel="auto", leaf_size=128, device="cpu"):
    """Classic Cornell box in [0,1]^3 (x right, y up, z into the box).

    variant:
      "empty"        — walls + light only
      "boxes"        — two diffuse boxes (the classic scene; config 1)
      "spheres"      — mirror + glass spheres (config 2)
      "glass_sphere" — boxes replaced by one big glass sphere
      "caustic"      — small bright light + glass sphere (config 4)
    """
    tris = []
    mats = []

    def add(ts, m):
        tris.extend(ts)
        mats.extend([m] * len(ts))

    # room: z in [0,1] is depth; camera looks +z from z<0
    add(quad((0, 0, 0), (0, 0, 1), (1, 0, 1), (1, 0, 0)), MAT_WHITE)   # floor
    add(quad((0, 1, 0), (1, 1, 0), (1, 1, 1), (0, 1, 1)), MAT_WHITE)   # ceiling
    add(quad((0, 0, 1), (0, 1, 1), (1, 1, 1), (1, 0, 1)), MAT_WHITE)   # back
    add(quad((1, 0, 0), (1, 0, 1), (1, 1, 1), (1, 1, 0)), MAT_RED)     # right (+x)
    add(quad((0, 0, 0), (0, 1, 0), (0, 1, 1), (0, 0, 1)), MAT_GREEN)   # left (-x)

    if variant == "caustic":
        # small light for sharp caustics
        lx0, lx1, lz0, lz1 = 0.45, 0.55, 0.45, 0.55
    else:
        lx0, lx1, lz0, lz1 = 0.343, 0.657, 0.332, 0.520  # 130x105/555 classic
    ly = 0.9995
    add(quad((lx0, ly, lz0), (lx1, ly, lz0), (lx1, ly, lz1), (lx0, ly, lz1)),
        MAT_LIGHT)

    spheres = []
    if variant == "boxes":
        add(_box((0.13, 0.0, 0.10), (0.43, 0.30, 0.40)), MAT_WHITE)   # short
        add(_box((0.53, 0.0, 0.50), (0.83, 0.60, 0.80)), MAT_WHITE)   # tall
    elif variant == "spheres":
        spheres = [((0.30, 0.18, 0.35), 0.18, MAT_GLASS),
                   ((0.70, 0.18, 0.65), 0.18, MAT_MIRROR)]
    elif variant == "glass_sphere":
        spheres = [((0.50, 0.25, 0.50), 0.25, MAT_GLASS)]
    elif variant == "caustic":
        spheres = [((0.50, 0.35, 0.50), 0.20, MAT_GLASS)]
    elif variant != "empty":
        raise ValueError(f"unknown cornell variant: {variant}")

    materials = [dict(m) for m in _MATERIALS]
    if light_scale != 1.0:
        materials[MAT_LIGHT]["emission"] = tuple(
            light_scale * np.asarray(materials[MAT_LIGHT]["emission"]))

    cam = make_camera(
        o=(0.50, 0.50, -1.44),
        look_at=(0.50, 0.50, 0.0),
        up=(0, 1, 0),
        vfov_deg=40.0,
        aspect=aspect,
    )
    return make_scene(
        np.stack(tris),
        np.asarray(mats, np.int32),
        materials,
        spheres=spheres,
        camera=cam,
        pad_to=pad_to,
        accel=accel,
        leaf_size=leaf_size,
        device=device,
    )


def furnace(albedo=0.6, radius=10.0, emission=1.0, device="cpu"):
    """Furnace test: camera inside a uniformly emissive box enclosing a
    diffuse sphere.  For albedo rho and emitter L the exact answer is
    L * sum_k rho^k."""
    mats = [
        {"kind": DIFFUSE, "albedo": (albedo, albedo, albedo)},
        {"kind": DIFFUSE, "albedo": (0, 0, 0),
         "emission": (emission, emission, emission)},
    ]
    tris = _box((-radius, -radius, -radius), (radius, radius, radius))
    tmats = [1] * len(tris)
    spheres = [((0.0, 0.0, 0.0), 1.0, 0)]
    cam = make_camera(o=(0, 0, -4.0), look_at=(0, 0, 0), up=(0, 1, 0),
                      vfov_deg=40.0, aspect=1.0)
    return make_scene(np.stack(tris), np.asarray(tmats, np.int32), mats,
                      spheres=spheres, camera=cam, device=device)
