"""The benchmark's own scene generators, frozen copies of the port's
builders (``tputracer_torch/scene/cornell.py``, ``scene/mesh.py``).

A configuration file names its generator (``"generator"``); the module
``perfbench/scenes/<generator>.py`` turns the file into host arrays with
``build(config) -> SceneArrays``.  The same arrays go to the program's
``make_scene`` and to the plain reference, so neither reads the other's
geometry.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass

import numpy as np

# material kinds, as the program numbers them
DIFFUSE = 0
MIRROR = 1
GLASS = 2


@dataclass(frozen=True)
class SceneArrays:
    """Host arrays of one scene, before any program-side layout."""

    tris: np.ndarray       # (T, 3, 3) float32: v0, v1, v2 per triangle
    tri_mat: np.ndarray    # (T,) int32
    materials: tuple       # dicts: kind, albedo, emission, ior
    spheres: tuple = ()    # (center(3), radius, material id)


def quad(p0, p1, p2, p3):
    """Two triangles for quad p0-p1-p2-p3 (vertices in order around it)."""
    p0, p1, p2, p3 = (np.asarray(p, np.float32) for p in (p0, p1, p2, p3))
    return [np.stack([p0, p1, p2]), np.stack([p0, p2, p3])]


def box(lo, hi):
    """Axis-aligned box as 12 triangles, in the port's face order."""
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    tris = []
    tris += quad((x0, y0, z0), (x1, y0, z0), (x1, y1, z0), (x0, y1, z0))
    tris += quad((x0, y0, z1), (x0, y1, z1), (x1, y1, z1), (x1, y0, z1))
    tris += quad((x0, y0, z0), (x0, y1, z0), (x0, y1, z1), (x0, y0, z1))
    tris += quad((x1, y0, z0), (x1, y0, z1), (x1, y1, z1), (x1, y1, z0))
    tris += quad((x0, y0, z0), (x0, y0, z1), (x1, y0, z1), (x1, y0, z0))
    tris += quad((x0, y1, z0), (x1, y1, z0), (x1, y1, z1), (x0, y1, z1))
    return tris


def materials_of(config):
    """The configuration's material table as the program's dicts."""
    return tuple({"kind": int(m["kind"]),
                  "albedo": tuple(m.get("albedo", (0.0, 0.0, 0.0))),
                  "emission": tuple(m.get("emission", (0.0, 0.0, 0.0))),
                  "ior": float(m.get("ior", 1.5))}
                 for m in config["materials"])


def build(config) -> SceneArrays:
    """The scene of a configuration, by its generator's name."""
    mod = importlib.import_module(f"perfbench.scenes.{config['generator']}")
    return mod.build(config)
