"""Wavefront unidirectional path tracer, port of ``tputracer/integrators/pt.py``.

One SoA state {o, d, throughput, L, alive, gate} for a chunk of paths is
advanced bounce by bounce; recursion, early-outs and Russian roulette are
lane masks.  Per bounce b:

  1. closest-hit intersect (accel.intersect: the CUDA kernel on the card)
  2. add emission — gated: at b==0, after a delta bounce, or (mis mode)
     weighted by the power heuristic against the NEE strategy
  3. NEE: sample an emitter point, one batched shadow-ray any-hit
  4. sample the BSDF, update throughput (detached-sampling grads)
  5. Russian roulette from cfg.rr_start on

The RNG is counter-based (tputracer_torch.rng) and keyed by the global
path uid, so the streams are those of the JAX package, whatever the
chunking.  Statistics stay on the device; nothing here synchronizes.
"""

from __future__ import annotations

import torch

from tputracer_torch import geometry as g
from tputracer_torch import rng
from tputracer_torch.accel import intersect, occluded
from tputracer_torch.bsdf import (emitted, eval_bsdf, nee_nonspecular,
                                  pdf_bsdf, sample_bsdf)
from tputracer_torch.lights import pdf_light_area, sample_light

_BIG = 3.0e38


def _power2(a, b):
    """Power heuristic (beta=2) MIS weight for strategy a vs b."""
    a2 = a * a
    return a2 / torch.clamp(a2 + b * b, min=1e-20)


def camera_rays(scene, uid, cfg):
    """Primary rays with per-sample pixel jitter."""
    cam = scene.camera
    pix = uid // cfg.spp
    px = (pix % cfg.width).to(torch.float32)
    py = (pix // cfg.width).to(torch.float32)
    j0, j1, _ = rng.uniform3(uid, rng.salt(0, rng.SLOT_CAMERA), cfg.seed)
    u = (px + j0) * (1.0 / cfg.width)
    v = (py + j1) * (1.0 / cfg.height)
    d = g.normalize(
        cam.corner[None, :]
        + u[:, None] * cam.du[None, :]
        + v[:, None] * cam.dv[None, :]
        - cam.o[None, :]
    )
    o = cam.o[None, :].expand(d.shape)
    return o, d


def _coherence_key(scene, o, d, alive):
    """Wavefront sort key: dead lanes last; live lanes grouped by origin
    cell (4^3 grid over the cluster bounds), then direction octant."""
    lo = torch.amin(scene.clus_min, dim=0)
    hi = torch.amax(scene.clus_max, dim=0)
    cell = torch.clamp(((o - lo) / (hi - lo + 1e-9) * 4.0).to(torch.int32),
                       0, 3)
    octant = ((d[:, 0] >= 0).to(torch.int32)
              + 2 * (d[:, 1] >= 0).to(torch.int32)
              + 4 * (d[:, 2] >= 0).to(torch.int32))
    key = (cell[:, 0] * 16 + cell[:, 1] * 4 + cell[:, 2]) * 8 + octant
    return torch.where(alive, key, 1 << 14)


def _bounce_step(scene, decision_scene, uid, carry, *, b, cfg, isect, occl):
    """One wavefront bounce: intersect, emission, NEE, BSDF sample, RR.

    carry = (o, d, L, thr, alive, prev_delta, prev_pdf); returns
    (carry', (rays_issued, n_active, rays_shadow)) with rays_shadow None
    on the terminal bounce (no continuation).
    """
    o, d, L, thr, alive, prev_delta, prev_pdf = carry
    zeros1 = torch.zeros(uid.shape, dtype=torch.float32, device=uid.device)
    eps = scene.eps

    # dead lanes get tmax = 0, which the kernel skips without testing
    issued = alive.sum(dtype=torch.float32)
    hit = isect(scene, o, d, tmin=zeros1, tmax=torch.where(alive, _BIG, 0.0))
    active = alive & hit.valid
    n_active = active.sum(dtype=torch.float32)

    # ---- emission at the hit vertex ----
    le = emitted(scene, hit.mat, hit.n, d)
    if cfg.mis and b > 0:
        pl_area, _ = pdf_light_area(scene, hit.prim)
        cos_l = torch.abs(g.dot(hit.n, d))
        # missed lanes carry t=_BIG whose square overflows to inf; clamp
        # them out so no NaN reaches the (masked) backward
        t_safe = torch.where(hit.valid, hit.t, 1.0)
        pl_sa = pl_area * t_safe**2 / torch.clamp(cos_l, min=1e-6)
        w_hit = torch.where(prev_delta, 1.0, _power2(prev_pdf, pl_sa))
    else:
        # NEE only: emitters counted at b==0 (prev_delta init) or after a
        # delta bounce — the double-count guard
        w_hit = prev_delta.to(torch.float32)
    L = L + torch.where(active[:, None], thr * le * w_hit[:, None], 0.0)

    if b == cfg.max_bounces:
        return (o, d, L, thr, alive, prev_delta, prev_pdf), \
            (issued, n_active, None)

    wo = -d
    ns = g.face_forward(hit.n, wo)

    # ---- next-event estimation ----
    ul0, ul1, ul2 = rng.uniform3(uid, rng.salt(b, rng.SLOT_LIGHT), cfg.seed)
    y, n_l, le_l, pdf_a, _, _ = sample_light(scene, ul0, ul1, ul2)
    to_l = y - hit.p
    dist2 = torch.clamp(g.dot(to_l, to_l), min=1e-12)
    dist = torch.sqrt(dist2)
    wi_l = to_l / dist[:, None]
    cos_p = g.dot(wi_l, ns)
    cos_l = g.dot(n_l, -wi_l)
    geom_ok = (cos_p > 0.0) & (cos_l > 1e-6)
    f = eval_bsdf(scene, hit.mat, hit.n, wo, wi_l)
    # trace only shadow rays that can contribute: live lane, light facing,
    # and a lobe that can eval nonzero; the rest get tmax = 0
    want = active & geom_ok & nee_nonspecular(scene, hit.mat)
    n_shadow = want.sum(dtype=torch.float32)
    so = hit.p + ns * eps
    occ = occl(scene, so, wi_l,
               tmax=torch.where(want, dist * (1.0 - 1e-3), 0.0))
    pdf_sa = pdf_a * dist2 / torch.clamp(cos_l, min=1e-6)
    if cfg.mis:
        pb = pdf_bsdf(scene, hit.mat, hit.n, wo, wi_l)
        w_nee = _power2(pdf_sa, pb)
    else:
        w_nee = 1.0
    contrib = thr * f * le_l * (w_nee * cos_p / pdf_sa)[:, None]
    nee_on = want & torch.logical_not(occ)
    L = L + torch.where(nee_on[:, None], contrib, 0.0)

    # ---- BSDF sampling / continuation ----
    ub0, ub1, ub2 = rng.uniform3(uid, rng.salt(b, rng.SLOT_BSDF), cfg.seed)
    wi, wgt, pdf_b, is_delta = sample_bsdf(
        scene, hit.mat, hit.n, wo, ub0, ub1, ub2,
        transport_radiance=cfg.transport_radiance,
        decision_scene=decision_scene,
    )
    thr = thr * wgt

    # ---- Russian roulette ----
    if b >= cfg.rr_start:
        ur, _, _ = rng.uniform3(uid, rng.salt(b, rng.SLOT_RR), cfg.seed)
        # q is the probability of a detached discrete decision: do not
        # differentiate the 1/q compensation through q
        q = torch.clamp(torch.amax(thr, dim=-1), 0.05, 0.95).detach()
        active = active & (ur < q)
        thr = thr / q[:, None]

    side = torch.where(g.dot(wi, hit.n) >= 0.0, 1.0, -1.0)
    o = hit.p + hit.n * (side * eps)[:, None]
    d = wi
    prev_delta = is_delta
    prev_pdf = pdf_b
    alive = active & (torch.amax(thr, dim=-1) > 0.0)
    return (o, d, L, thr, alive, prev_delta, prev_pdf), \
        (issued, n_active, n_shadow)


def trace_radiance(scene, uid, cfg, decision_scene=None,
                   intersect_fn=None, occluded_fn=None):
    """Radiance for a chunk of paths. uid: (n,) int64 -> (L (n,3), stats).

    intersect_fn / occluded_fn: optional intersection backends with the
    accel.intersect / accel.occluded signatures (the plain version of the
    kernel plugs in here to be compared with it on the card).

    With cfg.sort_rays (clustered scenes only; ignored on others), the
    wavefront is permuted after each bounce but the last two by a stable
    argsort of _coherence_key, and L is put back in uid order at the end.
    The RNG is keyed on uid and every step is per lane, so the image has
    the bits of the unsorted render.  cfg.remat is accepted and changes
    nothing in this forward pass; its per-bounce torch.utils.checkpoint
    comes with gradients."""
    n = uid.shape[0]
    dev = uid.device
    isect = intersect if intersect_fn is None else intersect_fn
    occl = occluded if occluded_fn is None else occluded_fn
    o, d = camera_rays(scene, uid, cfg)
    do_sort = cfg.sort_rays and scene.n_clusters > 0

    carry = (
        o, d,
        torch.zeros((n, 3), dtype=torch.float32, device=dev),   # L
        torch.ones((n, 3), dtype=torch.float32, device=dev),    # throughput
        torch.ones((n,), dtype=torch.bool, device=dev),         # alive
        torch.ones((n,), dtype=torch.bool, device=dev),         # prev_delta
        torch.zeros((n,), dtype=torch.float32, device=dev),     # prev_pdf
    )
    alive_counts = []
    issued_counts = []                    # closest-hit rays actually traced
    shadow_counts = []                    # shadow rays actually traced
    for b in range(cfg.max_bounces + 1):
        carry, (issued, n_active, n_shadow) = _bounce_step(
            scene, decision_scene, uid, carry, b=b, cfg=cfg,
            isect=isect, occl=occl)
        issued_counts.append(issued)
        alive_counts.append(n_active)
        if n_shadow is not None:
            shadow_counts.append(n_shadow)
        if do_sort and b < cfg.max_bounces - 1:
            perm = torch.argsort(_coherence_key(scene, carry[0], carry[1],
                                                carry[4]), stable=True)
            uid = uid[perm]
            carry = tuple(x[perm] for x in carry)

    L = carry[2]
    if do_sort:
        L = L[torch.argsort(uid)]   # back to uid order for the film
    empty = torch.zeros((0,), dtype=torch.float32, device=dev)
    stats = {
        "alive": torch.stack(alive_counts),
        "rays_closest": torch.stack(issued_counts),
        "rays_shadow": torch.stack(shadow_counts) if shadow_counts else empty,
    }
    return L, stats


def trace_chunked(scene, uids, cfg, decision_scene=None,
                  intersect_fn=None, occluded_fn=None):
    """Trace a flat (n,) uid tensor in cfg.chunk_size pieces -> (L (n,3), stats)."""
    n = uids.shape[0]
    chunk = min(cfg.chunk_size, n)
    n_chunks = -(-n // chunk)
    if n_chunks * chunk != n:
        raise ValueError(f"{n} paths do not split into chunks of {chunk}")
    Ls = []
    stats = None
    for i in range(n_chunks):
        L, st = trace_radiance(scene, uids[i * chunk:(i + 1) * chunk], cfg,
                               decision_scene=decision_scene,
                               intersect_fn=intersect_fn,
                               occluded_fn=occluded_fn)
        Ls.append(L)
        stats = st if stats is None else {k: stats[k] + st[k] for k in st}
    return torch.cat(Ls, dim=0), stats


def render_pt(scene, cfg, decision_scene=None, intersect_fn=None,
              occluded_fn=None):
    """Full-frame render: chunked wavefront + film average.

    Returns (image (H,W,3) float32 [row 0 = top], stats).  Paths are laid
    out pixel-major, so the per-path -> pixel reduction is a reshape/mean.
    """
    n_total = cfg.width * cfg.height * cfg.spp
    chunk = min(cfg.chunk_size, n_total)
    n_pad = -(-n_total // chunk) * chunk
    uids = torch.arange(n_pad, dtype=torch.int64, device=scene.device)
    L, stats = trace_chunked(scene, uids, cfg, decision_scene=decision_scene,
                             intersect_fn=intersect_fn,
                             occluded_fn=occluded_fn)
    img = film_from_radiance(L[:n_total], cfg)
    return img, stats


def film_from_radiance(L, cfg, rows=None, flip=True):
    """Per-path radiance (n,3) -> image rows, pixel-major layout.

    rows: number of image rows contained in L (defaults to full height).
    flip: camera dv points up, so uid row 0 is the BOTTOM of the image;
    flip=True returns row 0 = top.
    """
    rows = cfg.height if rows is None else rows
    img = L.reshape(rows, cfg.width, cfg.spp, 3).mean(dim=2)
    return torch.flip(img, dims=(0,)) if flip else img
