"""BASELINE config 3's room, as ``mesh_scene(subdiv=6)`` builds it: two
displaced icosphere blobs (81,920 and 20,480 triangles) in an open room
of four quads under one quad light, 102,410 triangles."""

from __future__ import annotations

import numpy as np

from perfbench.scenes import SceneArrays, materials_of, quad

_T = (1.0 + np.sqrt(5.0)) / 2.0
_ICO_V = np.array([
    [-1, _T, 0], [1, _T, 0], [-1, -_T, 0], [1, -_T, 0],
    [0, -1, _T], [0, 1, _T], [0, -1, -_T], [0, 1, -_T],
    [_T, 0, -1], [_T, 0, 1], [-_T, 0, -1], [-_T, 0, 1],
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


def displaced_blob(subdiv, amp, freq):
    """Icosphere displaced radially by a position-keyed sinusoid."""
    tv = icosphere(subdiv)
    p = tv.reshape(-1, 3)
    h = (np.sin(freq * p[:, 0] + 1.3) * np.sin(freq * 1.7 * p[:, 1] + 0.7)
         + 0.5 * np.sin(freq * 2.3 * p[:, 2] + 2.1)
         * np.sin(freq * 1.1 * p[:, 0] - 0.4))
    r = 1.0 + amp * h
    return (p * r[:, None]).reshape(tv.shape).astype(np.float32)


def build(config) -> SceneArrays:
    tris, mats = [], []
    for q in config["quads"]:
        ts = quad(*q["corners"])
        tris.extend(ts)
        mats.extend([q["material"]] * len(ts))
    blobs = []
    for b in config["blobs"]:
        blob = displaced_blob(b["subdiv"], b["amp"], b["freq"]) * b["scale"]
        for axis, off in enumerate(b["offset"]):
            if off:
                blob[:, :, axis] += off
        blobs.append(blob)
    blobs = np.concatenate(blobs, axis=0)
    tris = np.concatenate([np.stack(tris), blobs], axis=0)
    mats = np.concatenate([np.asarray(mats, np.int32),
                           np.full((blobs.shape[0],), config["blob_material"],
                                   np.int32)])
    return SceneArrays(tris=tris.astype(np.float32), tri_mat=mats,
                       materials=materials_of(config))
