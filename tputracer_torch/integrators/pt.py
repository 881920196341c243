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

On the card (:func:`pt_on_card`) steps 2–5 are two CUDA kernels a bounce
and chunk around the shadow-ray call (``integrators/pt_cuda.py``,
``csrc/pt.cu``), step 1 the closest hit's (t, prim) alone
(``accel.closest``): the same bits, the carry updated in place.  CPU
calls, gradient calls, ``decision_scene`` and injected intersectors take
the torch body, :func:`_bounce_step_plain`.

Each bounce b of a chunk is the phase ``pt.bounce.<b>``
(``tputracer_torch.trace.phase``): a span, and inside a CUDA graph's
capture a stretch that each replay times on the device, each bounce
opening on the event that closed the one before.  A chunked call
hands the capture its closest-hit rays per bounce, summed over the
chunks, as the count ``pt.live`` and its path count as ``pt.lanes``
(``trace.device_count``), which each replay's record then reads; where
the closest hits take B2's tree walk (a scene past the flat scan's
cluster count), also the walk's counts ``b2.nodes`` (boxes slab-tested),
``b2.visits`` (clusters visited) and ``b2.rays`` (live rays walked),
summed over the call's launches.  Each
bounce's record counts ``kernel``: 1 on the kernels' route, 0 on the
torch route.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from tputracer_torch import geometry as g
from tputracer_torch import rng
from tputracer_torch.accel import intersect, occluded, traverse_cuda
from tputracer_torch.bsdf import (emitted, eval_bsdf, nee_nonspecular,
                                  pdf_bsdf, sample_bsdf)
from tputracer_torch.integrators import pt_cuda
from tputracer_torch.lights import pdf_light_area, sample_light
from tputracer_torch.scene.types import kernel_route
from tputracer_torch.trace import device_count, phase, span

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
    # the origins' own memory, not a view of the camera's: the card's
    # kernels update the ray carry in place
    o = cam.o[None, :].expand(d.shape).clone(
        memory_format=torch.contiguous_format)
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


def pt_on_card(scene, uid, decision_scene=None, intersect_fn=None,
               occluded_fn=None):
    """Whether :func:`trace_radiance` takes the card's kernels
    (``scene.kernel_route``): uids on a CUDA device, no ``decision_scene``, the default intersectors and no
    gradient wanted.  CPU uids, and a call with grad enabled where a
    scene or camera tensor requires grad, a ``decision_scene`` or an
    injected intersector, take :func:`_bounce_step_plain` (the kernels
    have no backward, and decide with ``scene`` alone); any other device
    raises."""
    return kernel_route(scene, uid.device, "PT kernel", decision_scene,
                        intersect_fn, occluded_fn)


def _bounce_step_plain(scene, decision_scene, uid, carry, *, b, cfg, isect,
                       occl):
    """One wavefront bounce: intersect, emission, NEE, BSDF sample, RR.

    carry = (o, d, L, thr, alive, prev_delta, prev_pdf); returns
    (carry', (rays_issued, n_active, rays_shadow)) with rays_shadow None
    on the terminal bounce (no continuation).
    """
    o, d, L, thr, alive, prev_delta, prev_pdf = carry
    zeros1 = torch.zeros(uid.shape, dtype=torch.float32, device=uid.device)
    eps = scene.eps

    # dead lanes get tmax = 0, which the kernel skips without testing
    with span("pt.intersect"):
        issued = alive.sum(dtype=torch.float32)
        hit = isect(scene, o, d, tmin=zeros1,
                    tmax=torch.where(alive, _BIG, 0.0))
        active = alive & hit.valid
        n_active = active.sum(dtype=torch.float32)

    # ---- emission at the hit vertex ----
    with span("pt.emission"):
        le = emitted(scene, hit.mat, hit.n, d)
        if cfg.mis and b > 0:
            pl_area, _ = pdf_light_area(scene, hit.prim)
            cos_l = torch.abs(g.dot(hit.n, d))
            # missed lanes carry t=_BIG whose square overflows to inf;
            # clamp them out so no NaN reaches the (masked) backward
            t_safe = torch.where(hit.valid, hit.t, 1.0)
            pl_sa = pl_area * t_safe**2 / torch.clamp(cos_l, min=1e-6)
            w_hit = torch.where(prev_delta, 1.0, _power2(prev_pdf, pl_sa))
        else:
            # NEE only: emitters counted at b==0 (prev_delta init) or after
            # a delta bounce — the double-count guard
            w_hit = prev_delta.to(torch.float32)
        L = L + torch.where(active[:, None], thr * le * w_hit[:, None],
                            0.0)

    if b == cfg.max_bounces:
        return (o, d, L, thr, alive, prev_delta, prev_pdf), \
            (issued, n_active, None)

    wo = -d
    ns = g.face_forward(hit.n, wo)

    # ---- next-event estimation: a point on a light, then its shadow ray
    ul0, ul1, ul2 = rng.uniform3(uid, rng.salt(b, rng.SLOT_LIGHT), cfg.seed)
    with span("pt.light"):
        y, n_l, le_l, pdf_a, _, _ = sample_light(scene, ul0, ul1, ul2)
        to_l = y - hit.p
        dist2 = torch.clamp(g.dot(to_l, to_l), min=1e-12)
        dist = torch.sqrt(dist2)
        wi_l = to_l / dist[:, None]
        cos_p = g.dot(wi_l, ns)
        cos_l = g.dot(n_l, -wi_l)
        geom_ok = (cos_p > 0.0) & (cos_l > 1e-6)
    with span("pt.shadow"):
        f = eval_bsdf(scene, hit.mat, hit.n, wo, wi_l)
        # trace only shadow rays that can contribute: live lane, light
        # facing, and a lobe that can eval nonzero; the rest get tmax = 0
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

    # ---- BSDF sampling, then Russian roulette and the next ray ----
    ub0, ub1, ub2 = rng.uniform3(uid, rng.salt(b, rng.SLOT_BSDF), cfg.seed)
    with span("pt.sample"):
        wi, wgt, pdf_b, is_delta = sample_bsdf(
            scene, hit.mat, hit.n, wo, ub0, ub1, ub2,
            transport_radiance=cfg.transport_radiance,
            decision_scene=decision_scene,
        )
        thr = thr * wgt
    with span("pt.roulette"):
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
    kernel plugs in here to be compared with it on the card); either
    sends the chunk down the torch route (:func:`pt_on_card`).

    With cfg.sort_rays (clustered scenes only; ignored on others), the
    wavefront is permuted after each bounce but the last two by a stable
    argsort of _coherence_key, and L is put back in uid order at the end.
    The RNG is keyed on uid and every step is per lane, so the image has
    the bits of the unsorted render.

    With cfg.remat and gradients on, each bounce runs under a
    non-reentrant torch.utils.checkpoint: the backward pass recomputes the
    bounce, its intersection calls included, in place of keeping its
    intermediates.  The forward pass computes the same values.  The
    parameters live inside ``scene``, not in the positional tensors, and
    only the non-reentrant form passes gradients to them."""
    n = uid.shape[0]
    dev = uid.device
    isect = intersect if intersect_fn is None else intersect_fn
    occl = occluded if occluded_fn is None else occluded_fn
    on_card = pt_on_card(scene, uid, decision_scene, intersect_fn,
                         occluded_fn)
    wave = pt_cuda.Wavefront(scene, uid, cfg) if on_card else None
    o, d = camera_rays(scene, uid, cfg)
    do_sort = cfg.sort_rays and scene.n_clusters > 0
    remat = cfg.remat and torch.is_grad_enabled() and not on_card

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
    bounce = None                         # the last bounce's phase
    for b in range(cfg.max_bounces + 1):
        step = functools.partial(_bounce_step_plain, b=b, cfg=cfg,
                                 isect=isect, occl=occl)
        with phase(f"pt.bounce.{b}", after=bounce, lanes=n,
                   kernel=int(on_card)) as bounce:
            if on_card:
                carry, (issued, n_active, n_shadow) = pt_cuda.bounce_cuda(
                    wave, uid, carry, b=b)
            elif remat:
                # scene, decision_scene and uid are explicit arguments, as in
                # the reference, so the recomputation reads them and not
                # closure state; the bounce draws from the counter-based RNG,
                # so torch's RNG state needs no saving
                carry, (issued, n_active, n_shadow) = checkpoint(
                    step, scene, decision_scene, uid, carry,
                    use_reentrant=False, preserve_rng_state=False)
            else:
                carry, (issued, n_active, n_shadow) = step(
                    scene, decision_scene, uid, carry)
            issued_counts.append(issued)
            alive_counts.append(n_active)
            if n_shadow is not None:
                shadow_counts.append(n_shadow)
            if do_sort and b < cfg.max_bounces - 1:
                perm = torch.argsort(_coherence_key(scene, carry[0], carry[1],
                                                    carry[4]), stable=True)
                uid = uid[perm]
                carry = tuple(x[perm] for x in carry)
                if wave is not None:
                    wave.permute(perm)

    L = carry[2]
    if do_sort:
        L = L[torch.argsort(uid)]   # back to uid order for the film
    empty = torch.zeros((0,), dtype=torch.float32, device=dev)
    # float32 counts; the kernels' route counts in int32, which gives the
    # torch route's float sums exactly below 2^24 lanes a chunk
    stats = {k: torch.stack(v).to(torch.float32) if v else empty
             for k, v in (("alive", alive_counts),
                          ("rays_closest", issued_counts),
                          ("rays_shadow", shadow_counts))}
    return L, stats


def trace_chunked(scene, uids, cfg, decision_scene=None,
                  intersect_fn=None, occluded_fn=None):
    """Trace a flat (n,) uid tensor in cfg.chunk_size pieces -> (L (n,3), stats)."""
    n = uids.shape[0]
    chunk = min(cfg.chunk_size, n)
    n_chunks = -(-n // chunk)
    if n_chunks * chunk != n:
        raise ValueError(f"{n} paths do not split into chunks of {chunk}")
    # the tree walk's counters (accel.traverse_cuda), zeroed for this call
    walk = (traverse_cuda.tree_counts(scene)
            if intersect_fn is None and occluded_fn is None else None)
    Ls = []
    stats = None
    for i in range(n_chunks):
        L, st = trace_radiance(scene, uids[i * chunk:(i + 1) * chunk], cfg,
                               decision_scene=decision_scene,
                               intersect_fn=intersect_fn,
                               occluded_fn=occluded_fn)
        Ls.append(L)
        stats = st if stats is None else {k: stats[k] + st[k] for k in st}
    device_count("pt.live", stats["rays_closest"])
    device_count("pt.lanes", n)
    if walk is not None:
        for k, name in enumerate(("b2.nodes", "b2.visits", "b2.rays")):
            device_count(name, walk[k])
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
    with span("pt.film"):
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
