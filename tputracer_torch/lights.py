"""Emissive-area-light sampling for NEE, port of ``tputracer/lights.py``.

Each lane picks an emitter uniformly and a uniform point on it via the
sqrt parameterization, indexing the compact (E,)-row emitter tables
through ``lookup``.  ``Le`` is read from the material emission table, so
emitter-intensity gradients flow.
"""

from __future__ import annotations

import torch

from tputracer_torch import geometry as g
from tputracer_torch.lookup import fetch, fetch_int


def sample_light(scene, u0, u1, u2):
    """Sample one emitter point per lane.

    u0,u1,u2: (N,) uniforms.
    Returns (y, n_l, le, pdf_area, prim, mat):
      y        (N,3) point on the light
      n_l      (N,3) unit normal of the light (winding side = emitting side)
      le       (N,3) emitted radiance
      pdf_area (N,)  area-measure pdf of y (uniform emitter pick x uniform area)
      prim     (N,)  int32 triangle id of the sampled emitter
      mat      (N,)  int32 material id of the emitter
    """
    E = scene.n_emitters
    idx = torch.clamp((u0 * E).to(torch.int64), max=E - 1)   # (N,)
    prim = fetch_int(scene.emit_prim, idx)
    mat = fetch_int(scene.emit_mat, idx)
    area = fetch(scene.emit_area, idx)
    b1, b2 = g.uniform_sample_triangle(u1, u2)
    y = (fetch(scene.emit_v0, idx)
         + b1[:, None] * fetch(scene.emit_e1, idx)
         + b2[:, None] * fetch(scene.emit_e2, idx))
    n_l = fetch(scene.emit_n, idx)
    le = fetch(scene.mat_emission, mat)
    pdf_area = 1.0 / (area * E)
    return y, n_l, le, pdf_area, prim, mat


def pdf_light_area(scene, prim):
    """Area pdf of sampling a given emissive triangle id (for MIS)."""
    E = scene.n_emitters
    match = scene.emit_prim[None, :] == prim[:, None]       # (N,E)
    area = torch.sum(torch.where(match, scene.emit_area[None, :], 0.0), dim=1)
    is_emitter = torch.any(match, dim=1)
    pdf = torch.where(is_emitter,
                      1.0 / (torch.clamp(area, min=1e-20) * E), 0.0)
    return pdf, is_emitter
