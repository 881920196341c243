"""Wavefront bidirectional path tracer, port of ``tputracer/integrators/bdpt.py``.

BASELINE config 4 (the caustics scene).  For a chunk of paths:

  * both subpaths are wavefront walks over the whole batch, one from the
    camera and one from the emitters in importance transport, each
    storing a vertex SoA per depth: position, normal, throughput beta,
    forward/reverse area-measure pdfs, material, delta flag, valid;
  * every (s, t) connection is one masked batch (a BSDF eval at both
    endpoints, one batched shadow ray, a vectorized MIS ratio chain),
    unrolled in Python loops;
  * t=1 light tracing splats light-subpath vertices through the pinhole
    onto the film with ``index_add_`` into an (H*W + 1, 3) buffer whose
    last row takes the masked lanes.

On the card each walk is one CUDA kernel a vertex after its closest-hit
call (:func:`walk_on_card`; ``csrc/walk.cu``), and each of the last two
is two CUDA kernels a chunk around the same shadow-ray calls
(:func:`bdpt_on_card`; ``csrc/connect.cu``), all launched by
``integrators/bdpt_cuda.py``, with the same bits and, for the splats,
float atomics into an (H*W, 3) film.

MIS follows the area-measure formulation (Veach '97 ch. 10): the weight of
strategy (s, t) is 1 / (1 + sum_i prod ratios), delta vertices contribute
ratio 1 and suppress their adjacent strategies.

The RNG is counter-based on the global path uid, so renders do not depend
on the chunking.  Dead lanes and masked connections get tmax = 0, which
the intersection kernels answer without testing, and nothing here
synchronizes with the host: the ray counts stay device tensors.

On the card ``index_add_`` and the splat kernel's atomics add in no fixed
order, so the splat's last bits may change from run to run; the per-path
radiance ``L_own`` may not.

A chunk's five phases are spans (``tputracer_torch.trace.phase``):
``bdpt.eye_walk`` and ``bdpt.light_walk`` (count ``verts``), ``bdpt.s0``,
``bdpt.connect`` and ``bdpt.splat`` (count ``strategies``), each with the
count ``lanes``, and all but ``bdpt.s0`` with ``kernel`` (1 on the card's
route, 0 on the torch route); inside a CUDA graph's capture each also
leaves event nodes that time it on the device at every replay.
"""

from __future__ import annotations

import math

import torch

from tputracer_torch import geometry as g
from tputracer_torch import rng
from tputracer_torch.accel import intersect, occluded
from tputracer_torch.bsdf import emitted, eval_bsdf, pdf_bsdf, sample_bsdf
from tputracer_torch.integrators import bdpt_cuda
from tputracer_torch.integrators.pt import camera_rays, film_from_radiance
from tputracer_torch.lights import pdf_light_area, sample_light
from tputracer_torch.lookup import fetch_int
from tputracer_torch.scene.types import DIFFUSE, kernel_route
from tputracer_torch.trace import phase

_BIG = 3.0e38
_PI = math.pi


def _remap0(x):
    """Map 0 pdfs to 1 so delta/invalid factors drop out of ratio chains."""
    return torch.where(x > 0.0, x, 1.0)


def _convert_density(pdf_sa, p_from, p_to, n_to):
    """Solid-angle pdf at p_from -> area-measure pdf at p_to."""
    w = p_to - p_from
    dist2 = torch.clamp(g.dot(w, w), min=1e-12)
    inv = 1.0 / dist2
    cos = torch.abs(g.dot(n_to, w)) * torch.sqrt(inv)
    return pdf_sa * cos * inv


def _camera_forward(cam):
    """Unit forward axis of the pinhole camera (3,)."""
    c = cam.corner + 0.5 * cam.du + 0.5 * cam.dv - cam.o
    return c / torch.sqrt(torch.clamp(torch.sum(c * c), min=1e-20))


def _camera_area(cam):
    """World-space area of the image plane at unit distance (scalar)."""
    cr = g.cross(cam.du, cam.dv)
    return torch.sqrt(torch.clamp(torch.sum(cr * cr), min=1e-20))


def _splat_camera(cam):
    """The camera's terms of the t=1 splats: the unit forward axis, the
    image plane's area, and the squared lengths of its axes."""
    du2 = torch.clamp(torch.sum(cam.du * cam.du), min=1e-20)
    dv2 = torch.clamp(torch.sum(cam.dv * cam.dv), min=1e-20)
    return _camera_forward(cam), _camera_area(cam), du2, dv2


def _camera_pdf_sa(cam, d):
    """Solid-angle pdf of a camera ray direction d (N,3) -> (N,).

    uv is uniform over the full film, so p(w) = 1 / (A cos^3 theta) with
    A = |du x dv| (image plane at unit distance along the forward axis).
    """
    cos = torch.clamp(g.dot(d, _camera_forward(cam)), min=1e-6)
    return 1.0 / (_camera_area(cam) * cos**3)


def walk_on_card(scene, uid, isect=None):
    """Whether :func:`_walk` takes the card's kernel
    (``scene.kernel_route``): uids on a CUDA device, the default
    intersector and no gradient wanted.  CPU uids, an injected
    intersector, and a call with grad enabled where a scene or camera
    tensor requires grad, take :func:`_walk_plain` (the kernel has no
    backward); any other device raises."""
    return kernel_route(scene, uid.device, "BDPT walk", isect)


def _walk(scene, o, d, beta, pdf_sa, uid, cfg, n_verts, slot, origin,
          transport_radiance, start_p=None, isect=None, stats_acc=None):
    """Random walk of up to n_verts surface vertices; returns vertex list.
    On the card's route (:func:`walk_on_card`) one CUDA kernel a vertex
    after its closest hit (``bdpt_cuda.walk_cuda``, which updates ``o``,
    ``d`` and ``pdf_sa`` in place), elsewhere :func:`_walk_plain`; the
    same bits on every valid lane either way."""
    if walk_on_card(scene, uid, isect):
        return bdpt_cuda.walk_cuda(
            scene, o, d, beta, pdf_sa, uid, cfg, n_verts, slot, origin,
            transport_radiance, start_p=start_p, stats_acc=stats_acc)
    return _walk_plain(scene, o, d, beta, pdf_sa, uid, cfg, n_verts, slot,
                       origin, transport_radiance, start_p=start_p,
                       isect=isect, stats_acc=stats_acc)


def _walk_plain(scene, o, d, beta, pdf_sa, uid, cfg, n_verts, slot, origin,
                transport_radiance, start_p=None, isect=None,
                stats_acc=None):
    """Random walk of up to n_verts surface vertices; returns vertex list.
    The CPU, gradient and injected-intersector route, and the oracle of
    the card's kernel.

    Each vertex is a dict of (N,)-leading SoA tensors: p, ng, wo (unit
    toward predecessor), beta (throughput ARRIVING at the vertex), pdf_fwd
    / pdf_rev (area measure), mat, prim, delta, valid.  pdf_rev of vertex
    i is written one step later (it needs the walk's next direction);
    ``origin`` (light-walk y0) receives its pdf_rev the same way.

    Dead lanes get tmax = 0; the live-lane count is the "rays issued"
    stat (stats_acc["rays_closest"] when a stats dict is passed).
    """
    n = o.shape[0]
    isect = intersect if isect is None else isect
    zeros1 = torch.zeros((n,), dtype=torch.float32, device=o.device)
    eps = scene.eps
    prev_p = o if start_p is None else start_p
    prev = origin
    alive = torch.ones((n,), dtype=torch.bool, device=o.device)
    verts = []
    for i in range(n_verts):
        if stats_acc is not None:
            stats_acc["rays_closest"] = (stats_acc.get("rays_closest", 0.0)
                                         + alive.sum(dtype=torch.float32))
        hit = isect(scene, o, d, tmin=zeros1,
                    tmax=torch.where(alive, _BIG, 0.0))
        valid = alive & hit.valid
        pdf_fwd = _convert_density(pdf_sa, prev_p, hit.p, hit.n)
        kind = fetch_int(scene.mat_kind, hit.mat)
        v = dict(
            p=hit.p,
            ng=hit.n,
            wo=-d,
            beta=beta,
            pdf_fwd=torch.where(valid, pdf_fwd, 0.0),
            pdf_rev=zeros1,
            mat=hit.mat,
            prim=hit.prim,
            delta=(kind != DIFFUSE) & valid,
            valid=valid,
        )
        verts.append(v)
        if i == n_verts - 1:
            break

        wo = -d
        u0, u1, u2 = rng.uniform3(uid, rng.salt(i, slot), cfg.seed)
        wi, wgt, pdf_b, _ = sample_bsdf(
            scene, hit.mat, hit.n, wo, u0, u1, u2,
            transport_radiance=transport_radiance)
        # reverse pdf of the PREVIOUS vertex: prob of sampling wo (toward
        # the predecessor) given incoming wi; 0 through delta scatters,
        # which remap0 and the delta-strategy suppression handle
        rev_sa = pdf_bsdf(scene, hit.mat, hit.n, wi, wo)
        if prev is not None:
            pr = _convert_density(rev_sa, hit.p, prev["p"], prev["ng"])
            prev["pdf_rev"] = torch.where(valid, pr, prev["pdf_rev"])

        beta = beta * wgt
        side = torch.where(g.dot(wi, hit.n) >= 0.0, 1.0, -1.0)
        prev_p = hit.p
        o = hit.p + hit.n * (side * eps)[:, None]
        d = wi
        pdf_sa = pdf_b
        alive = valid & (torch.amax(beta, dim=-1) > 0.0)
        prev = v
    return verts


def _mis_weight(scene, cam, ys, zs, s, t, power=False):
    """MIS weight of strategy (s, t) over all strategies that sample the
    same full path.  ys/zs are the light/eye vertex lists; the connection
    joins ys[s-1] and zs[t-1] (s=0: zs[t-1] lies ON a light).  Returns (N,)
    weights; garbage on lanes the caller masks out.

    power=False: balance heuristic w = p_s / sum_i p_i.  power=True: the
    power heuristic with beta=2, w = p_s^2 / sum_i p_i^2; each accumulated
    pdf ratio is squared, the running ratio chain itself stays linear.
    """
    fwd_z = [v["pdf_fwd"] for v in zs[:t]]
    rev_z = [v["pdf_rev"] for v in zs[:t]]
    del_z = [v["delta"] for v in zs[:t]]
    fwd_y = [v["pdf_fwd"] for v in ys[:s]]
    rev_y = [v["pdf_rev"] for v in ys[:s]]
    del_y = [v["delta"] for v in ys[:s]]

    z = zs[t - 1]
    if s == 0:
        # zs[t-1] is on an emitter: its "reverse" pdf is the light-origin
        # area pdf; zs[t-2]'s is the light's cosine emission pdf
        pl, _ = pdf_light_area(scene, z["prim"])
        rev_z[t - 1] = pl
        if t >= 2:
            cos_l = torch.clamp(g.dot(z["ng"], z["wo"]), min=0.0)
            rev_z[t - 2] = _convert_density(
                cos_l / _PI, z["p"], zs[t - 2]["p"], zs[t - 2]["ng"])
    else:
        y = ys[s - 1]
        d_zy = y["p"] - z["p"]
        dist = torch.sqrt(torch.clamp(g.dot(d_zy, d_zy), min=1e-12))
        d_zy = d_zy / dist[:, None]
        d_yz = -d_zy

        # pdf of z from the light side
        if s == 1:
            sa = torch.clamp(g.dot(y["ng"], d_yz), min=0.0) / _PI
        else:
            sa = pdf_bsdf(scene, y["mat"], y["ng"], y["wo"], d_yz)
        rev_z[t - 1] = _convert_density(sa, y["p"], z["p"], z["ng"])

        # pdf of z's predecessor, from the light side through z
        if t >= 2:
            sa = pdf_bsdf(scene, z["mat"], z["ng"], d_zy, z["wo"])
            rev_z[t - 2] = _convert_density(
                sa, z["p"], zs[t - 2]["p"], zs[t - 2]["ng"])

        # pdf of y from the eye side
        if t == 1:
            sa = _camera_pdf_sa(cam, d_zy)  # z is the camera here
        else:
            sa = pdf_bsdf(scene, z["mat"], z["ng"], z["wo"], d_zy)
        rev_y[s - 1] = _convert_density(sa, z["p"], y["p"], y["ng"])

        # pdf of y's predecessor, from the eye side through y
        if s >= 2:
            sa = pdf_bsdf(scene, y["mat"], y["ng"], d_yz, y["wo"])
            rev_y[s - 2] = _convert_density(
                sa, y["p"], ys[s - 2]["p"], ys[s - 2]["ng"])

    sum_ri = torch.zeros_like(zs[0]["pdf_fwd"])
    ri = torch.ones_like(sum_ri)
    # hypothetical strategies that move the connection toward the camera
    for i in range(t - 1, 0, -1):
        ri = ri * _remap0(rev_z[i]) / _remap0(fwd_z[i])
        ok = torch.logical_not(del_z[i]) & torch.logical_not(del_z[i - 1])
        sum_ri = sum_ri + torch.where(ok, ri * ri if power else ri, 0.0)
    # ... and toward the light (area lights are never delta).  The two
    # chains are independent products, each from ratio 1 at the
    # connection edge (Veach '97 eq. 10.9)
    ri = torch.ones_like(sum_ri)
    for i in range(s - 1, -1, -1):
        ri = ri * _remap0(rev_y[i]) / _remap0(fwd_y[i])
        ok = torch.logical_not(del_y[i])
        if i > 0:
            ok = ok & torch.logical_not(del_y[i - 1])
        sum_ri = sum_ri + torch.where(ok, ri * ri if power else ri, 0.0)
    return 1.0 / (1.0 + sum_ri)


def eye_subpaths(scene, uid, cfg, isect=None, stats_acc=None):
    """Camera vertex + wavefront eye walk -> vertex SoA list zs."""
    n = uid.shape[0]
    dev = uid.device
    cam = scene.camera
    o, d = camera_rays(scene, uid, cfg)
    cam_v = dict(
        p=cam.o[None, :].expand(n, 3),
        ng=_camera_forward(cam)[None, :].expand(n, 3),
        wo=torch.zeros((n, 3), dtype=torch.float32, device=dev),
        beta=torch.ones((n, 3), dtype=torch.float32, device=dev),
        pdf_fwd=torch.ones((n,), dtype=torch.float32, device=dev),
        pdf_rev=torch.zeros((n,), dtype=torch.float32, device=dev),
        mat=torch.zeros((n,), dtype=torch.int32, device=dev),
        prim=torch.full((n,), -1, dtype=torch.int32, device=dev),
        delta=torch.zeros((n,), dtype=torch.bool, device=dev),
        valid=torch.ones((n,), dtype=torch.bool, device=dev),
    )
    return [cam_v] + _walk(
        scene, o, d, torch.ones((n, 3), dtype=torch.float32, device=dev),
        _camera_pdf_sa(cam, d), uid, cfg, cfg.max_bounces + 1, rng.SLOT_BSDF,
        origin=None, transport_radiance=True, isect=isect,
        stats_acc=stats_acc)


def light_subpaths(scene, uid, cfg, isect=None, stats_acc=None):
    """Emitter sample + importance-transport walk -> vertex SoA list ys."""
    n = uid.shape[0]
    dev = uid.device
    u0, u1, u2 = rng.uniform3(uid, rng.salt(0, rng.SLOT_LIGHT_ORIGIN),
                              cfg.seed)
    yp, n_l, le, pdf_a, lprim, lmat = sample_light(scene, u0, u1, u2)
    y0 = dict(
        p=yp,
        ng=n_l,
        wo=torch.zeros((n, 3), dtype=torch.float32, device=dev),
        beta=le / pdf_a[:, None],
        pdf_fwd=pdf_a,
        pdf_rev=torch.zeros((n,), dtype=torch.float32, device=dev),
        mat=lmat,
        prim=lprim,
        delta=torch.zeros((n,), dtype=torch.bool, device=dev),
        valid=torch.ones((n,), dtype=torch.bool, device=dev),
    )
    _, v1, v2 = rng.uniform3(uid, rng.salt(0, rng.SLOT_LIGHT_DIR), cfg.seed)
    d0 = g.to_world(g.cosine_sample_hemisphere(v1, v2), n_l)
    pdf_d0 = torch.clamp(g.dot(d0, n_l), min=0.0) / _PI
    return [y0] + _walk(
        scene, yp + n_l * scene.eps, d0, y0["beta"] * _PI, pdf_d0,
        uid, cfg, cfg.max_bounces + 1, rng.SLOT_LBSDF, origin=y0,
        transport_radiance=False, start_p=yp, isect=isect,
        stats_acc=stats_acc)


def s0_radiance(scene, cfg, zs):
    """s=0 strategies: the eye path hits an emitter (weighted
    unidirectional).  Depends only on the eye subpath."""
    cam = scene.camera
    V = cfg.max_bounces + 2
    L_own = torch.zeros_like(zs[0]["beta"])
    for t in range(2, min(len(zs), V) + 1):
        z = zs[t - 1]
        le_hit = emitted(scene, z["mat"], z["ng"], -z["wo"])
        _, is_em = pdf_light_area(scene, z["prim"])
        w = _mis_weight(scene, cam, [], zs, 0, t, power=cfg.mis_power)
        mask = z["valid"] & is_em
        L_own = L_own + torch.where(mask[:, None],
                                    z["beta"] * le_hit * w[:, None], 0.0)
    return L_own


def bdpt_on_card(scene, ys, zs):
    """Whether :func:`connection_radiance` and :func:`t1_splats` take the
    card's kernels (``scene.kernel_route``): vertices on a CUDA device and
    no gradient wanted.  CPU vertices, and a call with grad enabled where
    a vertex tensor or a scene or camera tensor requires grad, take the
    torch versions (the kernels have no backward); any other device
    raises."""
    return kernel_route(scene, zs[0]["beta"].device, "BDPT kernel",
                        tensors=(x for v in zs + ys for x in v.values()))


def connection_radiance(scene, cfg, ys, zs, occl=None, stats_acc=None):
    """s>=1, t>=2 vertex-connection strategies: (n, 3) radiance summed in
    (t, s) order, one shadow-ray call per (s, t).  On the card's route
    (:func:`bdpt_on_card`) two CUDA kernels around those calls
    (``bdpt_cuda``), elsewhere :func:`connection_radiance_plain`; the same
    bits either way."""
    fn = (bdpt_cuda.connection_radiance_cuda
          if bdpt_on_card(scene, ys, zs) else connection_radiance_plain)
    return fn(scene, cfg, ys, zs, occl=occl, stats_acc=stats_acc)


def connection_radiance_plain(scene, cfg, ys, zs, occl=None, stats_acc=None):
    """s>=1, t>=2 vertex-connection strategies: one masked batch and one
    shadow-ray batch per (s, t).  The CPU and gradient route, and the
    oracle of the card's kernels."""
    cam = scene.camera
    occl = occluded if occl is None else occl
    eps = scene.eps
    V = cfg.max_bounces + 2
    L_own = torch.zeros_like(zs[0]["beta"])
    for t in range(2, len(zs) + 1):
        for s in range(1, min(len(ys), V - t) + 1):
            y, z = ys[s - 1], zs[t - 1]
            d_raw = y["p"] - z["p"]
            dist2 = torch.clamp(g.dot(d_raw, d_raw), min=1e-12)
            dist = torch.sqrt(dist2)
            d_zy = d_raw / dist[:, None]
            d_yz = -d_zy
            f_z = eval_bsdf(scene, z["mat"], z["ng"], z["wo"], d_zy)
            if s == 1:
                # y0 IS the emitter sample: Le sits in beta; the "BSDF" at
                # the light is its one-sided emission indicator
                f_y = (g.dot(y["ng"], d_yz) > 0.0).to(torch.float32)[:, None]
            else:
                f_y = eval_bsdf(scene, y["mat"], y["ng"], y["wo"], d_yz)
            G = (torch.abs(g.dot(z["ng"], d_zy))
                 * torch.abs(g.dot(y["ng"], d_yz)) / dist2)
            c = z["beta"] * f_z * f_y * y["beta"] * G[:, None]
            mask = (z["valid"] & y["valid"]
                    & torch.logical_not(z["delta"])
                    & torch.logical_not(y["delta"])
                    & (torch.amax(c, dim=-1) > 0.0))
            # only candidate connections trace shadow rays (tmax = 0 on
            # the rest); their count is the shadow-ray stat
            if stats_acc is not None:
                stats_acc["rays_shadow"] = (stats_acc.get("rays_shadow", 0.0)
                                            + mask.sum(dtype=torch.float32))
            o_s = z["p"] + g.face_forward(z["ng"], d_zy) * eps
            occ = occl(scene, o_s, d_zy,
                       tmax=torch.where(mask, dist * (1.0 - 1e-3), 0.0))
            mask = mask & torch.logical_not(occ)
            w = _mis_weight(scene, cam, ys, zs, s, t, power=cfg.mis_power)
            L_own = L_own + torch.where(mask[:, None], c * w[:, None], 0.0)
    return L_own


def t1_splats(scene, cfg, ys, zs, occl=None, stats_acc=None):
    """t=1 light-tracing strategies: splat light-subpath vertices through
    the pinhole onto the film, one shadow-ray call per strategy.  Returns
    (H*W, 3) in uid pixel layout (row 0 = bottom).  On the card's route
    (:func:`bdpt_on_card`) two CUDA kernels around those calls
    (``bdpt_cuda``), elsewhere :func:`t1_splats_plain`; each splat's
    contribution and pixel the same bits either way."""
    fn = (bdpt_cuda.t1_splats_cuda
          if bdpt_on_card(scene, ys, zs) else t1_splats_plain)
    return fn(scene, cfg, ys, zs, occl=occl, stats_acc=stats_acc)


def t1_splats_plain(scene, cfg, ys, zs, occl=None, stats_acc=None):
    """t=1 light-tracing strategies: one masked batch, one shadow-ray batch
    and one ``index_add_`` per strategy.  Depends only on the light
    subpath (zs supplies just the shared camera vertex for the MIS
    chain).  The CPU and gradient route, and the oracle of the card's
    kernels."""
    cam = scene.camera
    occl = occluded if occl is None else occl
    n = ys[0]["pdf_fwd"].shape[0]
    V = cfg.max_bounces + 2
    n_pix = cfg.width * cfg.height
    # the last row takes the masked lanes
    splat = torch.zeros((n_pix + 1, 3), dtype=torch.float32,
                        device=ys[0]["p"].device)
    w_fwd, A, du2, dv2 = _splat_camera(cam)
    for s in range(1, min(len(ys), V - 1) + 1):
        y = ys[s - 1]
        d_raw = y["p"] - cam.o[None, :]
        dist2 = torch.clamp(g.dot(d_raw, d_raw), min=1e-12)
        dist = torch.sqrt(dist2)
        d_cy = d_raw / dist[:, None]                 # camera -> y
        cos_c = g.dot(d_cy, w_fwd)
        in_front = cos_c > 1e-6
        # project onto the unit-distance image plane -> film uv
        q = d_cy / torch.clamp(cos_c, min=1e-6)[:, None]
        rel = q - (cam.corner - cam.o)[None, :]
        uu = g.dot(rel, cam.du) / du2
        vv = g.dot(rel, cam.dv) / dv2
        # behind the camera uu reaches ~1e6, so uu * width can pass 2^31;
        # a float -> int cast out of range is undefined in torch (XLA's
        # saturates), so clamp to one pixel outside the film first
        px = torch.floor(torch.clamp(uu * cfg.width, -1.0, float(cfg.width))
                         ).to(torch.int64)
        py = torch.floor(torch.clamp(vv * cfg.height, -1.0,
                                     float(cfg.height))).to(torch.int64)
        on_film = ((px >= 0) & (px < cfg.width)
                   & (py >= 0) & (py < cfg.height) & in_front)

        if s == 1:
            f_y = (g.dot(y["ng"], -d_cy) > 0.0).to(torch.float32)[:, None]
        else:
            f_y = eval_bsdf(scene, y["mat"], y["ng"], y["wo"], -d_cy)
        cos_y = torch.abs(g.dot(y["ng"], d_cy))
        # importance W = WH / (A cos^3); camera->y conversion adds cos_y/r^2
        imp = (cfg.width * cfg.height) / (
            A * torch.clamp(cos_c, min=1e-6) ** 3)
        c = y["beta"] * f_y * (imp * cos_y / dist2)[:, None]
        mask = (y["valid"] & torch.logical_not(y["delta"]) & on_film
                & (torch.amax(c, dim=-1) > 0.0))
        if stats_acc is not None:
            stats_acc["rays_shadow"] = (stats_acc.get("rays_shadow", 0.0)
                                        + mask.sum(dtype=torch.float32))
        occ = occl(scene, cam.o[None, :].expand(n, 3), d_cy,
                   tmax=torch.where(mask, dist * (1.0 - 1e-3), 0.0))
        mask = mask & torch.logical_not(occ)
        w = _mis_weight(scene, cam, ys, zs, s, 1, power=cfg.mis_power)
        c = torch.where(mask[:, None], c * w[:, None], 0.0)
        pix_id = torch.where(mask, py * cfg.width + px, n_pix)
        splat.index_add_(0, pix_id, c)
    return splat[:n_pix]


def trace_bdpt(scene, uid, cfg, intersect_fn=None, occluded_fn=None):
    """BDPT radiance for a chunk of paths. uid: (n,) int64.

    Returns (L_own (n,3) per-path radiance of the s=0 and t>=2
    strategies, splat (H*W, 3) film scatter of the t=1 strategies in uid
    pixel layout (row 0 = bottom), NOT yet divided by the global path
    count, stats).

    intersect_fn / occluded_fn: optional intersection backends with the
    accel.intersect / accel.occluded signatures (the plain version of the
    kernel plugs in here to be compared with it on the card).

    stats: "rays_closest", the live subpath segments traced across both
    walks, and "rays_shadow", the candidate connection and t=1 shadow
    rays traced; both (,) float32 tensors on the device.
    """
    acc = {}
    n = uid.shape[0]
    walk_kernel = int(walk_on_card(scene, uid, intersect_fn))
    with phase("bdpt.eye_walk", lanes=n, kernel=walk_kernel) as rec:
        zs = eye_subpaths(scene, uid, cfg, isect=intersect_fn, stats_acc=acc)
        rec.add(verts=len(zs))
    with phase("bdpt.light_walk", lanes=n, kernel=walk_kernel) as rec:
        ys = light_subpaths(scene, uid, cfg, isect=intersect_fn,
                            stats_acc=acc)
        rec.add(verts=len(ys))
    V = cfg.max_bounces + 2
    on_card = int(bdpt_on_card(scene, ys, zs))
    with phase("bdpt.s0", lanes=n):
        L_s0 = s0_radiance(scene, cfg, zs)
    with phase("bdpt.connect", lanes=n,
               strategies=len(bdpt_cuda.strategies(len(zs), len(ys), V)),
               kernel=on_card):
        L_own = L_s0 + connection_radiance(
            scene, cfg, ys, zs, occl=occluded_fn, stats_acc=acc)
    with phase("bdpt.splat", lanes=n,
               strategies=len(bdpt_cuda.splat_strategies(len(ys), V)),
               kernel=on_card):
        splat = t1_splats(scene, cfg, ys, zs, occl=occluded_fn,
                          stats_acc=acc)
    zero = torch.zeros((), dtype=torch.float32, device=uid.device)
    stats = {"rays_closest": acc.get("rays_closest", zero),
             "rays_shadow": acc.get("rays_shadow", zero)}
    return L_own, splat, stats


def trace_bdpt_rows(scene, uids, cfg, rows_budget=None, intersect_fn=None,
                    occluded_fn=None, samples_per_pixel=None):
    """Trace a uid tensor covering whole image rows in row-aligned chunks.

    Returns (L_own (n,3) in uid order, splat (H*W,3) film scatter, stats
    dict of summed ray counts).  Chunks are whole image rows, never
    padded (padded paths would still splat onto real pixels): the chunk
    is the largest row count that divides the range and fits the budget
    (cfg.chunk_size paths).  samples_per_pixel (default cfg.spp) is the
    samples of each pixel that ``uids`` holds: progressive passes hold a
    slice of them.
    """
    n = uids.shape[0]
    per_row = cfg.width * (samples_per_pixel or cfg.spp)
    n_rows = n // per_row
    if n_rows * per_row != n:
        raise ValueError(f"{n} paths are not whole rows of {per_row}")
    rows = max(1, min((rows_budget or cfg.chunk_size) // per_row, n_rows))
    while n_rows % rows:
        rows -= 1
    chunk = rows * per_row
    L_parts = []
    splat_sum = torch.zeros((cfg.width * cfg.height, 3), dtype=torch.float32,
                            device=uids.device)
    stats = None
    for i in range(n // chunk):
        L, sp, st = trace_bdpt(scene, uids[i * chunk:(i + 1) * chunk], cfg,
                               intersect_fn=intersect_fn,
                               occluded_fn=occluded_fn)
        L_parts.append(L)
        splat_sum = splat_sum + sp
        stats = st if stats is None else {k: stats[k] + st[k] for k in st}
    return torch.cat(L_parts, dim=0), splat_sum, stats


def render_bdpt(scene, cfg, intersect_fn=None, occluded_fn=None):
    """Full-frame BDPT render -> (image (H,W,3), stats); row 0 = top.

    film = mean over per-pixel samples of the s=0 and t>=2 strategies
         + (1 / total paths) * scatter of the t=1 splats.
    stats adds "splat_energy", the sum of the splat film before scaling.
    """
    n_total = cfg.width * cfg.height * cfg.spp
    uids = torch.arange(n_total, dtype=torch.int64, device=scene.device)
    L_own, splat_sum, stats = trace_bdpt_rows(
        scene, uids, cfg, intersect_fn=intersect_fn, occluded_fn=occluded_fn)
    img = film_from_radiance(L_own, cfg)
    splat_img = torch.flip((splat_sum / float(n_total)).reshape(
        cfg.height, cfg.width, 3), dims=(0,))
    stats = dict(stats, splat_energy=splat_sum.sum())
    return img + splat_img, stats
