"""BSDFs: diffuse / mirror / dielectric, port of ``tputracer/bsdf/bsdf.py``.

Masked evaluate-all-lobes: every lane computes the diffuse, mirror and
glass results and selects by material tag.

Gradient discipline ("detached sampling"): sampled directions and
discrete lobe choices are constants with respect to the parameters; the
sampling pdf appears divided by its own ``.detach()`` so the forward value
is unchanged while backward keeps d(f)/d(params).  No tensor that may
require grad is updated in place.

Conventions: ``wo`` points away from the surface toward the previous
vertex; ``wi`` away toward the next; ``n`` is the outward geometric
normal by winding; returned pdfs are solid-angle pdfs; delta lobes report
pdf 0 and fold the discrete probability into the weight.
"""

from __future__ import annotations

import math

import torch

from tputracer_torch import geometry as g
from tputracer_torch.scene.types import DIFFUSE, GLASS, MIRROR

INV_PI = 1.0 / math.pi


def _lookup(table, idx):
    return table[idx.long()]


def emitted(scene, mat, n, d_in):
    """One-sided emitted radiance toward the ray (-d_in). (N,3)."""
    le = _lookup(scene.mat_emission, mat)            # (N,3)
    front = (g.dot(d_in, n) < 0.0)[:, None]
    return torch.where(front, le, 0.0)


def eval_bsdf(scene, mat, n, wo, wi):
    """f(wo, wi): nonzero only for the diffuse lobe (deltas never eval)."""
    kind = _lookup(scene.mat_kind, mat)
    ns = g.face_forward(n, wo)
    same_side = (g.dot(wi, ns) > 0.0) & (g.dot(wo, ns) > 0.0)
    f_diff = _lookup(scene.mat_albedo, mat) * INV_PI
    sel = (kind == DIFFUSE) & same_side
    return torch.where(sel[:, None], f_diff, 0.0)


def nee_nonspecular(scene, mat):
    """Lanes whose BSDF can evaluate nonzero toward a light (NEE gate).

    Structural, not value-based: delta lobes always eval to 0, so their
    shadow rays are skipped; diffuse lanes are kept even with albedo 0 so
    a black material still receives NEE gradient."""
    return _lookup(scene.mat_kind, mat) == DIFFUSE


def pdf_bsdf(scene, mat, n, wo, wi):
    """Solid-angle sampling pdf of :func:`sample_bsdf` for MIS (diffuse only)."""
    kind = _lookup(scene.mat_kind, mat)
    ns = g.face_forward(n, wo)
    cos_i = g.dot(wi, ns)
    p = torch.clamp(cos_i, min=0.0) * INV_PI
    return torch.where((kind == DIFFUSE) & (g.dot(wo, ns) > 0.0), p, 0.0)


def _fresnel_dielectric(cos_i, eta_i, eta_t):
    """Exact unpolarized Fresnel reflectance; cos_i >= 0 on the incident side."""
    sin2_t = (eta_i / eta_t) ** 2 * torch.clamp(1.0 - cos_i**2, min=0.0)
    tir = sin2_t >= 1.0
    # clamp away from 0: sqrt'(0) = inf, and TIR lanes (where cos_t is
    # unused) would poison ior-gradients with 0 * inf = NaN
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, 1e-12, 1.0))
    r_par = (eta_t * cos_i - eta_i * cos_t) / (eta_t * cos_i + eta_i * cos_t)
    r_per = (eta_i * cos_i - eta_t * cos_t) / (eta_i * cos_i + eta_t * cos_t)
    f = 0.5 * (r_par**2 + r_per**2)
    return torch.where(tir, 1.0, f), cos_t, tir


def sample_bsdf(scene, mat, n, wo, u0, u1, u2, transport_radiance=True,
                decision_scene=None):
    """Sample wi for every lane; masked-all-lobes select by material tag.

    Returns (wi, weight, pdf, is_delta):
      weight = f * |cos| / pdf   (with detached-pdf gradient trick)
      pdf    = solid-angle pdf (0 for delta lobes)

    decision_scene: optional Scene whose parameters drive the DISCRETE
    choices (the glass reflect/refract pick and its detached pick
    probability) while ``scene`` drives the differentiable transport math;
    None means ``scene``.  It serves finite-difference checks of IOR
    gradients, which must replay the decisions of the linearization point.
    """
    dsc = scene if decision_scene is None else decision_scene
    kind = _lookup(scene.mat_kind, mat)
    albedo = _lookup(scene.mat_albedo, mat)          # (N,3)
    ns = g.face_forward(n, wo)                       # shading-side normal

    # --- diffuse: cosine-hemisphere ---
    wi_d = g.to_world(g.cosine_sample_hemisphere(u1, u2), ns)
    pdf_d = torch.clamp(g.dot(wi_d, ns), min=0.0) * INV_PI
    w_d = albedo                                     # f cos / pdf == albedo

    # --- mirror: perfect reflection about ns ---
    wi_m = 2.0 * g.dotk(wo, ns) * ns - wo
    w_m = albedo

    # --- glass: Fresnel-weighted reflect-or-refract ---
    entering = g.dot(wo, n) > 0.0
    ior = _lookup(scene.mat_ior, mat)
    eta_i = torch.where(entering, 1.0, ior)
    eta_t = torch.where(entering, ior, 1.0)
    cos_i = torch.abs(g.dot(wo, ns))
    fr, cos_t, tir = _fresnel_dielectric(cos_i, eta_i, eta_t)
    if decision_scene is None:
        fr_dec, cos_t_dec, tir_dec = fr, cos_t, tir
        eta_dec = eta_i / eta_t
    else:
        ior_d = _lookup(dsc.mat_ior, mat)
        ei_d = torch.where(entering, 1.0, ior_d)
        et_d = torch.where(entering, ior_d, 1.0)
        fr_dec, cos_t_dec, tir_dec = _fresnel_dielectric(cos_i, ei_d, et_d)
        eta_dec = ei_d / et_d
    pick_reflect = (u0 < fr_dec.detach()) | tir_dec
    eta = eta_i / eta_t
    wi_refl = 2.0 * g.dotk(wo, ns) * ns - wo
    wi_refr = g.normalize(
        -eta_dec[:, None] * wo + (eta_dec * cos_i - cos_t_dec)[:, None] * ns)
    wi_g = torch.where(pick_reflect[:, None], wi_refl, wi_refr)
    # detached-pdf ratio: forward == 1, backward keeps dF/d(ior)
    pr = torch.clamp(fr_dec, 1e-4, 1.0).detach()
    pt = torch.clamp(1.0 - fr_dec, 1e-4, 1.0).detach()
    scale_refr = eta**2 if transport_radiance else 1.0   # radiance transport
    w_g_refl = (fr / pr)[:, None] * albedo
    w_g_refr = ((1.0 - fr) / pt * scale_refr)[:, None] * albedo
    w_g = torch.where(pick_reflect[:, None], w_g_refl, w_g_refr)

    # --- select by material tag ---
    is_m = (kind == MIRROR)[:, None]
    is_g = (kind == GLASS)[:, None]
    wi = torch.where(is_g, wi_g, torch.where(is_m, wi_m, wi_d))
    wi = wi.detach()                    # detached sampling: directions are data
    weight = torch.where(is_g, w_g, torch.where(is_m, w_m, w_d))
    pdf = torch.where(kind == DIFFUSE, pdf_d, 0.0)
    is_delta = kind != DIFFUSE
    return wi, weight, pdf, is_delta
