"""The caustics Cornell box, in [0,1]^3 (x right, y up, z into the box),
as ``cornell_box("caustic")`` builds it: the room's five walls and a
small ceiling light, 12 triangles, above one glass sphere."""

from __future__ import annotations

import numpy as np

from perfbench.scenes import SceneArrays, materials_of, quad


def build(config) -> SceneArrays:
    geo = config["geometry"]
    mat = config["material_ids"]
    tris, mats = [], []

    def add(ts, m):
        tris.extend(ts)
        mats.extend([m] * len(ts))

    add(quad((0, 0, 0), (0, 0, 1), (1, 0, 1), (1, 0, 0)), mat["white"])
    add(quad((0, 1, 0), (1, 1, 0), (1, 1, 1), (0, 1, 1)), mat["white"])
    add(quad((0, 0, 1), (0, 1, 1), (1, 1, 1), (1, 0, 1)), mat["white"])
    add(quad((1, 0, 0), (1, 0, 1), (1, 1, 1), (1, 1, 0)), mat["red"])
    add(quad((0, 0, 0), (0, 1, 0), (0, 1, 1), (0, 0, 1)), mat["green"])
    lx0, lx1, lz0, lz1 = geo["light_xz"]
    ly = geo["light_y"]
    add(quad((lx0, ly, lz0), (lx1, ly, lz0), (lx1, ly, lz1), (lx0, ly, lz1)),
        mat["light"])
    spheres = tuple((tuple(c), float(r), mat[m])
                    for c, r, m in geo["spheres"])
    return SceneArrays(tris=np.stack(tris).astype(np.float32),
                       tri_mat=np.asarray(mats, np.int32),
                       materials=materials_of(config), spheres=spheres)
