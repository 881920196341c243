"""The plain reference: a wavefront path tracer in plain PyTorch.

It implements the semantics that the program states (the JAX package's
``integrators/pt.py`` and ``tests/oracle/oracle_pt.py``, NEE without MIS)
from the benchmark's own scene arrays, independently of the program:

  * its own pcg3d of (path uid, salt, seed), in int64 arithmetic taken
    mod 2^32, so it draws the program's random numbers;
  * brute-force Moeller-Trumbore over every triangle (the program uses
    Pluecker edge signs and a cluster BVH), spheres by the stable
    quadratic, in blocks of rays;
  * diffuse, mirror and dielectric lobes; next-event estimation toward a
    uniformly picked emitter triangle; Russian roulette;
  * gradients through the shading (the sampled directions and discrete
    choices are constants), so the fit's reference differentiates it.

It imports nothing of the program or of JAX.  ``dtype`` is the precision
of every float it computes: float32 for the reference, bfloat16 for the
control.  Which emitter a light sample picks depends on the emitter
table's order, which the program's BVH may permute; ``emit_order`` says
which order of this scene's emitter triangles to use.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

BIG = 3.0e38
SALT_STRIDE = 8
SLOT_LIGHT, SLOT_BSDF, SLOT_RR, SLOT_CAMERA = 0, 1, 2, 3
DIFFUSE, MIRROR, GLASS = 0, 1, 2
_M32 = 0xFFFFFFFF
# elements of one (rays x triangles) block of the intersection
_BLOCK = 1 << 24


# ---------------------------------------------------------------- pcg3d

def _mul32(a, b):
    """(a * b) mod 2^32 for int64 tensors of values in [0, 2^32), with no
    intermediate past 2^34."""
    lo = (a & 0xFFFF) * (b & 0xFFFF)
    mid = ((a >> 16) * (b & 0xFFFF) + (a & 0xFFFF) * (b >> 16)) & 0xFFFF
    return (lo + (mid << 16)) & _M32


def uniform3(uid, salt, seed, dtype):
    """Three U[0,1) streams, pcg3d(uid, salt, seed) (Jarzynski & Olano):
    the top 24 bits of each output over 2^24."""
    x = uid.to(torch.int64) & _M32
    y = torch.full_like(x, int(salt) & _M32)
    z = torch.full_like(x, int(seed) & _M32)
    x = (_mul32(x, torch.full_like(x, 1664525)) + 1013904223) & _M32
    y = (_mul32(y, torch.full_like(y, 1664525)) + 1013904223) & _M32
    z = (_mul32(z, torch.full_like(z, 1664525)) + 1013904223) & _M32
    for shift in (False, True):
        x = (x + _mul32(y, z)) & _M32
        y = (y + _mul32(z, x)) & _M32
        z = (z + _mul32(x, y)) & _M32
        if not shift:
            x, y, z = x ^ (x >> 16), y ^ (y >> 16), z ^ (z >> 16)
    return tuple((((v >> 8) & 0xFFFFFF).to(torch.float32)
                  * (1.0 / 16777216.0)).to(dtype) for v in (x, y, z))


# ------------------------------------------------------------ the scene

@dataclass
class RefScene:
    """Triangles, spheres, materials and emitters as tensors of dtype."""

    v0: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    nrm: torch.Tensor      # unit geometric normals by winding
    tri_mat: torch.Tensor
    sph_c: torch.Tensor
    sph_r: torch.Tensor
    sph_mat: torch.Tensor
    kind: torch.Tensor
    albedo: torch.Tensor
    emission: torch.Tensor
    ior: torch.Tensor
    emit_tri: torch.Tensor  # emitter triangle ids, in emit_order
    emit_area: torch.Tensor
    eps: float


def _unit(v):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(
        1e-20)


def make_ref_scene(arrays, *, eps, device, dtype, albedo=None,
                   emission=None, emit_order=None):
    """A RefScene from the benchmark's SceneArrays.  ``albedo`` and
    ``emission`` replace the material tables (tensors that may require
    grad); the emitters are the triangles whose base material emits."""
    f = dict(device=device, dtype=dtype)
    tv = torch.as_tensor(arrays.tris, device=device).to(dtype)
    v0 = tv[:, 0]
    e1 = tv[:, 1] - v0
    e2 = tv[:, 2] - v0
    n = torch.linalg.cross(e1, e2)
    tri_mat = torch.as_tensor(arrays.tri_mat, device=device).long()
    mats = arrays.materials
    base_em = torch.tensor([m["emission"] for m in mats], **f)
    emits = (base_em > 0).any(dim=1)[tri_mat].nonzero()[:, 0]
    if emit_order is not None:
        emits = emits[torch.as_tensor(emit_order, device=device)]
    sph = arrays.spheres
    return RefScene(
        v0=v0, e1=e1, e2=e2, nrm=_unit(n), tri_mat=tri_mat,
        sph_c=torch.tensor([s[0] for s in sph], **f).reshape(-1, 3),
        sph_r=torch.tensor([s[1] for s in sph], **f),
        sph_mat=torch.tensor([s[2] for s in sph], device=device).long(),
        kind=torch.tensor([m["kind"] for m in mats], device=device),
        albedo=(torch.tensor([m["albedo"] for m in mats], **f)
                if albedo is None else albedo.to(dtype)),
        emission=base_em if emission is None else emission.to(dtype),
        ior=torch.tensor([m["ior"] for m in mats], **f),
        emit_tri=emits,
        emit_area=0.5 * torch.linalg.vector_norm(n[emits], dim=1),
        eps=eps)


def n_emitters(arrays):
    """How many emitter triangles the scene has."""
    em = [any(c > 0 for c in m["emission"]) for m in arrays.materials]
    return int(sum(em[int(m)] for m in arrays.tri_mat))


def camera(o, look_at, up, vfov_deg, aspect, device, dtype):
    """Pinhole camera (o, corner, du, dv): ray(u, v) through corner +
    u du + v dv, u and v in [0, 1]."""
    f = dict(device=device, dtype=dtype)
    o = torch.as_tensor(o, **f)
    w = _unit(torch.as_tensor(look_at, **f) - o)
    u = _unit(torch.linalg.cross(w, torch.as_tensor(up, **f)))
    v = torch.linalg.cross(u, w)
    h = math.tan(math.radians(vfov_deg) * 0.5)
    du = 2.0 * h * aspect * u
    dv = 2.0 * h * v
    return o, o + w - 0.5 * du - 0.5 * dv, du, dv


# --------------------------------------------------------- intersection

def _dot(a, b):
    return (a * b).sum(-1)


def intersect(sc, o, d, tmax):
    """Closest hit with tmin = 0 < t < tmax: (t, tri or -1, sphere or -1).
    Rays with tmax = 0 are not tested."""
    n = o.shape[0]
    best_t = tmax.clone()
    best_tri = torch.full((n,), -1, dtype=torch.long, device=o.device)
    live = (tmax > 0).nonzero()[:, 0]
    T = sc.v0.shape[0]
    rows = max(1, _BLOCK // max(T, 1))
    for s in range(0, live.numel(), rows):
        idx = live[s:s + rows]
        ro, rd = o[idx][:, None, :], d[idx][:, None, :]
        h = torch.linalg.cross(rd.expand(-1, T, -1),
                               sc.e2[None].expand(idx.numel(), -1, -1))
        a = _dot(sc.e1[None], h)
        ok = a.abs() > 1e-12
        inv = torch.where(ok, 1.0 / torch.where(ok, a, 1.0), 0.0)
        sv = ro - sc.v0[None]
        u = inv * _dot(sv, h)
        q = torch.linalg.cross(sv, sc.e1[None].expand(idx.numel(), -1, -1))
        v = inv * _dot(rd, q)
        t = inv * _dot(sc.e2[None], q)
        hit = (ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0)
               & (t < best_t[idx][:, None]))
        tt = torch.where(hit, t, BIG)
        tmin_blk, arg = tt.min(dim=1)
        better = tmin_blk < best_t[idx]
        best_t[idx] = torch.where(better, tmin_blk, best_t[idx])
        best_tri[idx] = torch.where(better, arg, best_tri[idx])
    best_sph = torch.full_like(best_tri, -1)
    for j in range(sc.sph_r.shape[0]):
        oc = o - sc.sph_c[j]
        b = _dot(oc, d)
        c = _dot(oc, oc) - sc.sph_r[j] ** 2
        disc = b * b - c
        sq = torch.sqrt(disc.clamp_min(0.0))
        t0 = -b - sq
        tj = torch.where(t0 > 0, t0, -b + sq)
        take = (disc > 0) & (tj > 0) & (tj < best_t) & (tmax > 0)
        best_t = torch.where(take, tj, best_t)
        best_sph = torch.where(take, j, best_sph)
        best_tri = torch.where(take, -1, best_tri)
    return best_t, best_tri, best_sph


# ------------------------------------------------------------- shading

def _onb(n):
    nx, ny, nz = n.unbind(-1)
    s = torch.where(nz >= 0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (s + nz)
    b = nx * ny * a
    t = torch.stack([1.0 + s * nx * nx * a, s * b, -s * nx], -1)
    bt = torch.stack([b, s + ny * ny * a, -ny], -1)
    return t, bt


def _fresnel(cos_i, eta_i, eta_t):
    sin2_t = (eta_i / eta_t) ** 2 * (1.0 - cos_i ** 2).clamp_min(0.0)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt((1.0 - sin2_t).clamp(1e-12, 1.0))
    r_par = (eta_t * cos_i - eta_i * cos_t) / (eta_t * cos_i + eta_i * cos_t)
    r_per = (eta_i * cos_i - eta_t * cos_t) / (eta_i * cos_i + eta_t * cos_t)
    return torch.where(tir, 1.0, 0.5 * (r_par ** 2 + r_per ** 2)), cos_t, tir


def radiance(sc, cam, uid, r, seed):
    """Per-path radiance (n, 3) of paths ``uid`` under render settings
    ``r`` (width, height, spp, max_bounces, rr_start)."""
    dt, dev = sc.v0.dtype, uid.device
    n = uid.shape[0]
    co, corner, du, dv = cam
    spp, W, H = r["spp"], r["width"], r["height"]
    pix = uid // spp
    j0, j1, _ = uniform3(uid, SLOT_CAMERA, seed, dt)
    u = ((pix % W).to(dt) + j0) * (1.0 / W)
    v = ((pix // W).to(dt) + j1) * (1.0 / H)
    d = _unit(corner + u[:, None] * du + v[:, None] * dv - co)
    o = co.expand(n, 3)
    L = torch.zeros((n, 3), device=dev, dtype=dt)
    thr = torch.ones((n, 3), device=dev, dtype=dt)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    prev_delta = torch.ones(n, dtype=torch.bool, device=dev)
    E = sc.emit_tri.shape[0]
    for b in range(r["max_bounces"] + 1):
        with torch.no_grad():
            t, tri, sph = intersect(sc, o, d, torch.where(alive, BIG, 0.0)
                                    .to(dt))
        valid = (tri >= 0) | (sph >= 0)
        active = alive & valid
        t1 = torch.where(valid, t, 1.0)
        p = o + t1[:, None] * d
        is_tri = tri >= 0
        ti, si = tri.clamp_min(0), sph.clamp_min(0)
        if sc.sph_r.numel():
            nrm = torch.where(is_tri[:, None], sc.nrm[ti],
                              (p - sc.sph_c[si]) / sc.sph_r[si][:, None])
            mat = torch.where(is_tri, sc.tri_mat[ti], sc.sph_mat[si])
        else:
            nrm, mat = sc.nrm[ti], sc.tri_mat[ti]
        mat = torch.where(active, mat, 0)
        front = (_dot(d, nrm) < 0)[:, None]
        le = torch.where(front, sc.emission[mat], 0.0)
        L = L + torch.where((active & prev_delta)[:, None], thr * le, 0.0)
        if b == r["max_bounces"]:
            break
        wo = -d
        ns = torch.where((_dot(nrm, wo) < 0)[:, None], -nrm, nrm)
        kind = sc.kind[mat]
        diffuse = kind == DIFFUSE

        # next-event estimation
        ul0, ul1, ul2 = uniform3(uid, b * SALT_STRIDE + SLOT_LIGHT, seed, dt)
        li = (ul0 * E).long().clamp_max(E - 1)
        lt = sc.emit_tri[li]
        su = torch.sqrt(ul1)
        b1, b2 = 1.0 - su, ul2 * su
        y = sc.v0[lt] + b1[:, None] * sc.e1[lt] + b2[:, None] * sc.e2[lt]
        to_l = y - p
        dist2 = _dot(to_l, to_l).clamp_min(1e-12)
        dist = torch.sqrt(dist2)
        wi_l = to_l / dist[:, None]
        cos_p = _dot(wi_l, ns)
        cos_l = _dot(sc.nrm[lt], -wi_l)
        same = (cos_p > 0) & (_dot(wo, ns) > 0)
        want = active & (cos_p > 0) & (cos_l > 1e-6) & diffuse
        with torch.no_grad():
            st, stri, ssph = intersect(
                sc, p + ns * sc.eps, wi_l,
                torch.where(want, dist * (1.0 - 1e-3), 0.0).to(dt))
        occ = (stri >= 0) | (ssph >= 0)
        pdf_a = 1.0 / (sc.emit_area[li] * E)
        pdf_sa = pdf_a * dist2 / cos_l.clamp_min(1e-6)
        f = torch.where((diffuse & same)[:, None],
                        sc.albedo[mat] * (1.0 / math.pi), 0.0)
        le_l = sc.emission[sc.tri_mat[lt]]
        contrib = thr * f * le_l * (cos_p / pdf_sa)[:, None]
        L = L + torch.where((want & ~occ)[:, None], contrib, 0.0)

        # BSDF sampling
        ub0, ub1, ub2 = uniform3(uid, b * SALT_STRIDE + SLOT_BSDF, seed, dt)
        rr = torch.sqrt(ub1)
        phi = (2.0 * math.pi) * ub2
        tb, bb = _onb(ns)
        loc_z = torch.sqrt((1.0 - ub1).clamp_min(0.0))
        wi_d = ((rr * torch.cos(phi))[:, None] * tb
                + (rr * torch.sin(phi))[:, None] * bb + loc_z[:, None] * ns)
        refl = 2.0 * _dot(wo, ns)[:, None] * ns - wo
        albedo = sc.albedo[mat]
        entering = _dot(wo, nrm) > 0
        ior = sc.ior[mat]
        eta_i = torch.where(entering, 1.0, ior)
        eta_t = torch.where(entering, ior, 1.0)
        cos_i = _dot(wo, ns).abs()
        fr, cos_t, tir = _fresnel(cos_i, eta_i, eta_t)
        pick_refl = (ub0 < fr) | tir
        eta = eta_i / eta_t
        refr = _unit(-eta[:, None] * wo + (eta * cos_i - cos_t)[:, None] * ns)
        # a pick's weight over its own (detached) probability: 1 unless
        # the probability was clamped at 1e-4
        w_refl = fr / fr.clamp(1e-4, 1.0).detach()
        w_refr = (1.0 - fr) / (1.0 - fr).clamp(1e-4, 1.0).detach() * eta ** 2
        glass_w = torch.where(pick_refl, w_refl, w_refr)[:, None] * albedo
        is_m, is_g = (kind == MIRROR)[:, None], (kind == GLASS)[:, None]
        wi = torch.where(is_g, torch.where(pick_refl[:, None], refl, refr),
                         torch.where(is_m, refl, wi_d)).detach()
        thr = thr * torch.where(is_g, glass_w, albedo)

        # Russian roulette
        if b >= r["rr_start"]:
            ur, _, _ = uniform3(uid, b * SALT_STRIDE + SLOT_RR, seed, dt)
            qq = thr.amax(-1).clamp(0.05, 0.95).detach()
            active = active & (ur < qq)
            thr = thr / qq[:, None]
        side = torch.where(_dot(wi, nrm) >= 0, 1.0, -1.0).to(dt)
        o = p + nrm * (side * sc.eps)[:, None]
        d = wi
        prev_delta = ~diffuse
        alive = active & (thr.amax(-1) > 0)
    return L


def render_pixels(sc, cam, pixels, r, seed, chunk=1 << 18):
    """Mean radiance (P, 3) of each pixel id (row-major from the bottom
    row, as the paths are numbered) over its r["spp"] samples."""
    spp = r["spp"]
    out = []
    step = max(1, chunk // spp)
    for s in range(0, pixels.numel(), step):
        pix = pixels[s:s + step]
        uid = (pix[:, None] * spp
               + torch.arange(spp, device=pix.device)[None]).reshape(-1)
        out.append(radiance(sc, cam, uid, r, seed).reshape(-1, spp, 3)
                   .mean(dim=1))
    return torch.cat(out)


def render_image(sc, cam, r, seed, chunk=1 << 18):
    """The (H, W, 3) image, row 0 = top."""
    pix = torch.arange(r["width"] * r["height"], device=sc.v0.device)
    img = render_pixels(sc, cam, pix, r, seed, chunk)
    return img.reshape(r["height"], r["width"], 3).flip(0)
