"""Triangle-mesh scenes, port of ``tputracer/scene/mesh.py``.

A minimal OBJ (+ MTL) loader and the procedural ~100k-triangle scene of
BASELINE config 3: a subdivided icosphere displaced by a deterministic,
position-keyed sinusoid (shared vertices stay bitwise identical, so the
mesh has no cracks), in an open room with one area light.  The host code
is the JAX package's NumPy code, so both packages build identical arrays;
``device`` says where the finished scene's tensors go: the card unless
the caller asks for the CPU.
"""

from __future__ import annotations

import os

import numpy as np

from tputracer_torch.scene.cornell import quad
from tputracer_torch.scene.types import (
    DIFFUSE,
    GLASS,
    MIRROR,
    make_camera,
    make_scene,
)


def _lines(source):
    """Lines of an OBJ/MTL source: a file path or the text itself."""
    if "\n" in source or "\r" in source:
        return source.splitlines()
    with open(source) as fh:
        return fh.read().splitlines()


def _face_indices(parts, n_verts):
    """0-based vertex indices of an ``f`` line (negative = from the end)."""
    idx = [int(p.split("/")[0]) for p in parts[1:]]
    return [i - 1 if i > 0 else n_verts + i for i in idx]


def load_obj(source, flip_winding=False):
    """Minimal OBJ parser: v / f lines, polygon fan triangulation.

    source: file path or a string containing OBJ text.
    Returns (T, 3, 3) float32 triangle soup.
    """
    verts, tris = [], []
    for line in _lines(source):
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "v":
            verts.append([float(x) for x in parts[1:4]])
        elif parts[0] == "f":
            idx = _face_indices(parts, len(verts))
            for k in range(1, len(idx) - 1):   # fan triangulation
                tri = (idx[0], idx[k], idx[k + 1])
                tris.append(tri[::-1] if flip_winding else tri)
    v = np.asarray(verts, np.float32)
    f = np.asarray(tris, np.int64)
    return v[f]


_ICO_T = (1.0 + np.sqrt(5.0)) / 2.0
_ICO_V = np.array([
    [-1, _ICO_T, 0], [1, _ICO_T, 0], [-1, -_ICO_T, 0], [1, -_ICO_T, 0],
    [0, -1, _ICO_T], [0, 1, _ICO_T], [0, -1, -_ICO_T], [0, 1, -_ICO_T],
    [_ICO_T, 0, -1], [_ICO_T, 0, 1], [-_ICO_T, 0, -1], [-_ICO_T, 0, 1],
], np.float64)
_ICO_F = np.array([
    [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
    [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
    [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
    [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
], np.int64)


def icosphere(subdiv):
    """Unit icosphere as a (20 * 4^subdiv, 3, 3) float64 triangle soup."""
    tv = _ICO_V[_ICO_F]
    tv /= np.linalg.norm(tv, axis=-1, keepdims=True)
    for _ in range(subdiv):
        a, b, c = tv[:, 0], tv[:, 1], tv[:, 2]
        ab, bc, ca = 0.5 * (a + b), 0.5 * (b + c), 0.5 * (c + a)
        tv = np.concatenate([
            np.stack([a, ab, ca], axis=1),
            np.stack([ab, b, bc], axis=1),
            np.stack([ca, bc, c], axis=1),
            np.stack([ab, bc, ca], axis=1),
        ], axis=0)
        tv /= np.linalg.norm(tv, axis=-1, keepdims=True)
    return tv


def displaced_blob(subdiv=6, amp=0.12, freq=4.5):
    """Icosphere displaced radially by deterministic sinusoidal noise."""
    tv = icosphere(subdiv)                       # (F,3,3) on unit sphere
    p = tv.reshape(-1, 3)
    h = (np.sin(freq * p[:, 0] + 1.3) * np.sin(freq * 1.7 * p[:, 1] + 0.7)
         + 0.5 * np.sin(freq * 2.3 * p[:, 2] + 2.1)
         * np.sin(freq * 1.1 * p[:, 0] - 0.4))
    r = 1.0 + amp * h
    return (p * r[:, None]).reshape(tv.shape).astype(np.float32)


def mesh_scene(subdiv=6, leaf_size=128, accel="auto", light_scale=1.0,
               device="cuda"):
    """BASELINE config 3: a >100k-triangle mesh scene in a lit room.

    The main displaced blob has 20*4^subdiv triangles (subdiv=6 ->
    81,920); at subdiv >= 6 a second quarter-scale blob (subdiv-1 ->
    20,480) stands beside it, for 102,410 triangles with the room quads.
    subdiv=5 and below stay single-blob (small variants).
    """
    tris, mats = [], []

    def add(ts, m):
        tris.extend(ts)
        mats.extend([m] * len(ts))

    # room: floor + back wall + two side walls (open front/top for light)
    add(quad((-2, 0, -2), (-2, 0, 2), (2, 0, 2), (2, 0, -2)), 0)   # floor
    add(quad((-2, 0, 2), (-2, 3, 2), (2, 3, 2), (2, 0, 2)), 0)     # back
    add(quad((-2, 0, -2), (-2, 3, -2), (-2, 3, 2), (-2, 0, 2)), 1)  # left
    add(quad((2, 0, -2), (2, 0, 2), (2, 3, 2), (2, 3, -2)), 2)     # right
    add(quad((-0.6, 2.8, -0.6), (0.6, 2.8, -0.6), (0.6, 2.8, 0.6),
             (-0.6, 2.8, 0.6)), 3)                                 # light

    blob = displaced_blob(subdiv=subdiv) * 0.8
    blob[:, :, 1] += 1.0                       # rest on the floor-ish
    blobs = [blob]
    if subdiv >= 6:
        small = displaced_blob(subdiv=subdiv - 1, freq=6.5) * 0.4
        small[:, :, 0] += 1.25
        small[:, :, 1] += 0.45
        small[:, :, 2] -= 0.75
        blobs.append(small)
    blobs = np.concatenate(blobs, axis=0)
    tris = np.concatenate([np.stack(tris), blobs], axis=0)
    mats = np.concatenate([np.asarray(mats, np.int32),
                           np.full((blobs.shape[0],), 4, np.int32)])

    materials = [
        {"kind": DIFFUSE, "albedo": (0.73, 0.73, 0.73)},
        {"kind": DIFFUSE, "albedo": (0.65, 0.05, 0.05)},
        {"kind": DIFFUSE, "albedo": (0.12, 0.45, 0.15)},
        {"kind": DIFFUSE, "albedo": (0, 0, 0),
         "emission": tuple(light_scale * np.array((16.0, 14.0, 9.0)))},
        {"kind": DIFFUSE, "albedo": (0.55, 0.62, 0.75)},
    ]
    cam = make_camera(o=(0.0, 1.4, -4.2), look_at=(0.0, 1.0, 0.0),
                      up=(0, 1, 0), vfov_deg=45.0, aspect=1.0,
                      device="cpu")   # host side: make_scene reads it back
    return make_scene(tris, mats, materials, camera=cam,
                      accel=accel, leaf_size=leaf_size, device=device)


def load_mtl(source):
    """Minimal .mtl parser -> {name: material dict}.

    Mapping to the three BSDF families:
      Ke > 0                        -> emissive diffuse (area light)
      illum 6/7, or Ni > 1.01 with transparency (d < 1 / Tr > 0)
                                    -> GLASS (ior = Ni)
      illum 3/5                     -> MIRROR (albedo = Ks)
      otherwise                     -> DIFFUSE (albedo = Kd)
    """
    mats, cur = {}, None
    for line in _lines(source):
        parts = line.split()
        if not parts or parts[0].startswith("#"):
            continue
        key = parts[0]
        if key == "newmtl":
            cur = {"Kd": (0.7, 0.7, 0.7), "Ks": (0.9, 0.9, 0.9),
                   "Ke": (0.0, 0.0, 0.0), "Ni": 1.0, "d": 1.0,
                   "illum": 2}
            mats[parts[1]] = cur
        elif cur is None:
            continue
        elif key in ("Kd", "Ks", "Ke"):
            cur[key] = tuple(float(x) for x in parts[1:4])
        elif key == "Ni":
            cur["Ni"] = float(parts[1])
        elif key == "d":
            cur["d"] = float(parts[1])
        elif key == "Tr":
            cur["d"] = 1.0 - float(parts[1])
        elif key == "illum":
            cur["illum"] = int(parts[1])

    out = {}
    for name, m in mats.items():
        if any(c > 0.0 for c in m["Ke"]):
            out[name] = {"kind": DIFFUSE, "albedo": (0, 0, 0),
                         "emission": m["Ke"]}
        elif m["illum"] in (6, 7) or (m["Ni"] > 1.01 and m["d"] < 1.0):
            out[name] = {"kind": GLASS, "albedo": (1.0, 1.0, 1.0),
                         "ior": max(m["Ni"], 1.01)}
        elif m["illum"] in (3, 5):
            out[name] = {"kind": MIRROR, "albedo": m["Ks"]}
        else:
            out[name] = {"kind": DIFFUSE, "albedo": m["Kd"]}
    return out


def load_obj_with_materials(source, mtl_source=None):
    """OBJ parser with usemtl/mtllib support.

    source: file path or OBJ text; mtl_source: optional .mtl path/text
    (overrides mtllib).  For a file path, mtllib names resolve relative
    to the OBJ's directory.  Returns (tv (T,3,3), tri_mat (T,), materials
    list) ready for make_scene; faces before any usemtl get a default
    grey diffuse.
    """
    text = "\n" in source or "\r" in source
    base = "." if text else os.path.dirname(os.path.abspath(source))
    mtl = {} if mtl_source is None else load_mtl(mtl_source)

    verts, tris, tri_mat = [], [], []
    materials = [{"kind": DIFFUSE, "albedo": (0.7, 0.7, 0.7)}]
    name_to_id = {}
    cur_id = 0
    for line in _lines(source):
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "mtllib" and mtl_source is None:
            path = os.path.join(base, parts[1])
            if os.path.exists(path):
                mtl.update(load_mtl(path))
        elif parts[0] == "usemtl":
            name = parts[1]
            if name not in name_to_id:
                materials.append(mtl.get(
                    name, {"kind": DIFFUSE, "albedo": (0.7, 0.7, 0.7)}))
                name_to_id[name] = len(materials) - 1
            cur_id = name_to_id[name]
        elif parts[0] == "v":
            verts.append([float(x) for x in parts[1:4]])
        elif parts[0] == "f":
            idx = _face_indices(parts, len(verts))
            for k in range(1, len(idx) - 1):
                tris.append((idx[0], idx[k], idx[k + 1]))
                tri_mat.append(cur_id)
    v = np.asarray(verts, np.float32)
    f = np.asarray(tris, np.int64)
    return v[f], np.asarray(tri_mat, np.int32), materials


def obj_scene(source, materials=None, mat_id=0, camera=None,
              mtl_source=None, device="cuda", **kw):
    """Build a renderable Scene straight from an OBJ source (file/string).

    With materials=None the OBJ's own mtllib/usemtl statements drive
    material assignment (load_obj_with_materials); pass an explicit
    materials list + mat_id to override with a uniform material."""
    camera = camera or make_camera(o=(0, 0.5, -3.0), look_at=(0, 0, 0),
                                   up=(0, 1, 0), vfov_deg=40.0, aspect=1.0,
                                   device="cpu")
    if materials is None:
        tv, mats, materials = load_obj_with_materials(
            source, mtl_source=mtl_source)
        if len(materials) == 1:     # no usemtl: a grey diffuse and a light
            materials = [
                {"kind": DIFFUSE, "albedo": (0.7, 0.7, 0.7)},
                {"kind": DIFFUSE, "albedo": (0, 0, 0),
                 "emission": (15.0, 15.0, 15.0)},
            ]
        return make_scene(tv, mats, materials, camera=camera, device=device,
                          **kw)
    tv = load_obj(source)
    mats = np.full((tv.shape[0],), mat_id, np.int32)
    return make_scene(tv, mats, materials, camera=camera, device=device, **kw)
