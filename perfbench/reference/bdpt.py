"""The plain BDPT reference: a bidirectional path tracer in plain PyTorch.

It implements the semantics that the program states (Veach '97 ch. 10,
as the JAX package's and the port's ``integrators/bdpt.py`` document
them) from the benchmark's own scene arrays, independently of the
program:

  * an eye subpath from the pinhole and a light subpath from a uniformly
    picked emitter triangle, each of ``max_bounces + 1`` surface vertices
    (the light subpath also keeps its start point on the emitter), with
    the same random streams: pcg3d of (path uid, bounce * 8 + slot,
    seed) in the slots ``SLOT_CAMERA``, ``SLOT_BSDF`` (the eye walk),
    ``SLOT_LIGHT_ORIGIN``, ``SLOT_LIGHT_DIR`` and ``SLOT_LBSDF`` (the
    light walk), ``perfbench/reference/pt.py``'s ``uniform3``;
  * each vertex keeps its area-measure pdfs, forward and reverse; the
    weight of strategy (s, t) is the balance heuristic (or the power
    heuristic, beta = 2) over the ratio chains toward the camera and
    toward the light, a delta vertex contributing ratio 1 and
    suppressing the strategies that would connect at it or its
    neighbour; delta lobes (mirror, glass) never connect;
  * strategies s = 0 (the eye path hits an emitter), s >= 1 with t >= 2
    (a shadow ray between the two subpaths), and t = 1 (the light
    subpath's vertex seen through the pinhole, its importance
    W H / (A cos^3), splatted onto the film);
  * the film is each pixel's mean of its paths' s = 0 and t >= 2
    radiance, plus the sum of the t = 1 splats over the total number of
    paths;
  * intersection is ``pt.py``'s: brute-force Moeller-Trumbore over every
    triangle and the stable sphere quadratic (the program uses Pluecker
    edge signs).  The lobes are ``pt.py``'s too, the dielectric with
    radiance transport (the refracted weight times eta^2) on the eye
    walk and importance transport (without it) on the light walk.

Departures from the program, none of which changes a result:

  * the emitter pdf of a hit triangle is read from a table over the
    triangles; the program matches the hit against every emitter through
    an (N, E) matrix (``lights.pdf_light_area``, a known gap it mirrors
    from the JAX package);
  * the emitters are taken in the arrays' order.  The program keeps its
    triangle table's order, which only a cluster BVH permutes; the
    caller asserts the program's scene has none rather than probing;
  * sphere hits carry no primitive id (the program numbers them after
    the padded triangles): they are never emitters;
  * paths run in blocks of whole pixels, which the counter-based streams
    make invisible; the splat is summed with ``index_add_`` over all of
    them, in no fixed order on the card, as the program's is.

It imports nothing of the program or of JAX.  ``dtype`` is the precision
of every float it computes: float32 for the reference, bfloat16 for the
control.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from perfbench.reference import pt
from perfbench.reference.pt import (BIG, DIFFUSE, GLASS, MIRROR,
                                    SALT_STRIDE, SLOT_BSDF, SLOT_CAMERA,
                                    _dot, _fresnel, _onb, _unit, uniform3)

SLOT_LIGHT_ORIGIN, SLOT_LIGHT_DIR, SLOT_LBSDF = 4, 5, 6


@dataclass
class Vertex:
    """One subpath vertex over a block of paths (N-leading tensors)."""

    p: torch.Tensor
    ng: torch.Tensor        # unit geometric normal by winding
    wo: torch.Tensor        # unit, toward the predecessor
    beta: torch.Tensor      # throughput arriving at the vertex
    pdf_fwd: torch.Tensor   # area pdf of sampling it from its predecessor
    pdf_rev: torch.Tensor   # area pdf of sampling it from its successor
    mat: torch.Tensor
    prim: torch.Tensor      # triangle id, -1 for a sphere or a miss
    delta: torch.Tensor
    valid: torch.Tensor


@dataclass
class Cam:
    o: torch.Tensor
    corner: torch.Tensor
    du: torch.Tensor
    dv: torch.Tensor
    fwd: torch.Tensor       # unit forward axis
    area: torch.Tensor      # |du x dv|: the film's area at unit distance


def camera(cam):
    """A Cam of ``pt.camera``'s (o, corner, du, dv)."""
    o, corner, du, dv = cam
    fwd = _unit(corner + 0.5 * du + 0.5 * dv - o)
    area = torch.linalg.vector_norm(torch.linalg.cross(du, dv))
    return Cam(o, corner, du, dv, fwd, area)


def _salt(b, slot):
    return b * SALT_STRIDE + slot


def _to_area(pdf_sa, p_from, p_to, n_to):
    """A solid-angle pdf at p_from as an area pdf at p_to."""
    w = p_to - p_from
    inv = 1.0 / _dot(w, w).clamp_min(1e-12)
    return pdf_sa * (_dot(n_to, w).abs() * torch.sqrt(inv)) * inv


def _cam_pdf(cam, d):
    """Solid-angle pdf of the camera ray direction d."""
    cos = _dot(d, cam.fwd).clamp_min(1e-6)
    return 1.0 / (cam.area * cos ** 3)


def _facing(n, w):
    return torch.where((_dot(n, w) < 0)[:, None], -n, n)


def _pdf(sc, mat, n, wo, wi):
    """Solid-angle pdf of sampling wi from wo (the diffuse lobe only)."""
    ns = _facing(n, wo)
    p = _dot(wi, ns).clamp_min(0.0) / math.pi
    return torch.where((sc.kind[mat] == DIFFUSE) & (_dot(wo, ns) > 0), p,
                       0.0)


def _eval(sc, mat, n, wo, wi):
    """f(wo, wi): the diffuse lobe's albedo / pi on one side, else 0."""
    ns = _facing(n, wo)
    ok = ((sc.kind[mat] == DIFFUSE) & (_dot(wi, ns) > 0)
          & (_dot(wo, ns) > 0))
    return torch.where(ok[:, None], sc.albedo[mat] / math.pi, 0.0)


def _emitter_pdf(sc, prim):
    """(area pdf of sampling triangle ``prim`` as a light, whether it is
    an emitter); -1 is none."""
    E = sc.emit_tri.shape[0]
    T = sc.v0.shape[0]
    table = torch.zeros(T + 1, dtype=sc.v0.dtype, device=sc.v0.device)
    table[sc.emit_tri] = 1.0 / (sc.emit_area.clamp_min(1e-20) * E)
    pdf = table[torch.where(prim >= 0, prim, T)]
    return pdf, pdf > 0


def _cosine_dir(n, u1, u2):
    """A cosine-distributed direction about the unit normal n."""
    tb, bb = _onb(n)
    r, phi = torch.sqrt(u1), (2.0 * math.pi) * u2
    z = torch.sqrt((1.0 - u1).clamp_min(0.0))
    return ((r * torch.cos(phi))[:, None] * tb
            + (r * torch.sin(phi))[:, None] * bb + z[:, None] * n)


def _sample(sc, mat, n, wo, u0, u1, u2, radiance):
    """(wi, weight f cos / pdf, solid-angle pdf, 0 for a delta lobe)."""
    ns = _facing(n, wo)
    kind, albedo = sc.kind[mat], sc.albedo[mat]
    wi_d = _cosine_dir(ns, u1, u2)
    pdf_d = _dot(wi_d, ns).clamp_min(0.0) / math.pi
    refl = 2.0 * _dot(wo, ns)[:, None] * ns - wo
    entering = _dot(wo, n) > 0
    ior = sc.ior[mat]
    eta_i = torch.where(entering, 1.0, ior)
    eta_t = torch.where(entering, ior, 1.0)
    cos_i = _dot(wo, ns).abs()
    fr, cos_t, tir = _fresnel(cos_i, eta_i, eta_t)
    pick_refl = (u0 < fr) | tir
    eta = eta_i / eta_t
    refr = _unit(-eta[:, None] * wo + (eta * cos_i - cos_t)[:, None] * ns)
    w_refl = fr / fr.clamp(1e-4, 1.0)
    w_refr = (1.0 - fr) / (1.0 - fr).clamp(1e-4, 1.0)
    if radiance:
        w_refr = w_refr * eta ** 2
    glass_w = torch.where(pick_refl, w_refl, w_refr)[:, None] * albedo
    is_m, is_g = (kind == MIRROR)[:, None], (kind == GLASS)[:, None]
    wi = torch.where(is_g, torch.where(pick_refl[:, None], refl, refr),
                     torch.where(is_m, refl, wi_d))
    weight = torch.where(is_g, glass_w, albedo)
    return wi, weight, torch.where(kind == DIFFUSE, pdf_d, 0.0)


def _hit(sc, o, d, tmax):
    """(valid, p, unit normal, mat, triangle or -1) of the closest hit."""
    t, tri, sph = pt.intersect(sc, o, d, tmax)
    valid = (tri >= 0) | (sph >= 0)
    p = o + torch.where(valid, t, 1.0)[:, None] * d
    is_tri = (tri >= 0)[:, None]
    ti, si = tri.clamp_min(0), sph.clamp_min(0)
    if sc.sph_r.numel():
        n = torch.where(is_tri, sc.nrm[ti],
                        (p - sc.sph_c[si]) / sc.sph_r[si][:, None])
        mat = torch.where(is_tri[:, 0], sc.tri_mat[ti], sc.sph_mat[si])
    else:
        n, mat = sc.nrm[ti], sc.tri_mat[ti]
    return valid, p, n, torch.where(valid, mat, 0), tri


def _walk(sc, o, d, beta, pdf_sa, prev_p, prev, uid, seed, n_verts, slot,
          radiance):
    """A wavefront random walk of n_verts surface vertices; ``prev`` (the
    light subpath's start, or None) gets its reverse pdf from the first."""
    alive = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
    zero = torch.zeros_like(pdf_sa)
    verts = []
    for i in range(n_verts):
        valid, p, n, mat, tri = _hit(sc, o, d, torch.where(alive, BIG, 0.0)
                                     .to(o.dtype))
        valid = alive & valid
        v = Vertex(p=p, ng=n, wo=-d, beta=beta,
                   pdf_fwd=torch.where(valid, _to_area(pdf_sa, prev_p, p, n),
                                       0.0),
                   pdf_rev=zero, mat=mat, prim=tri,
                   delta=(sc.kind[mat] != DIFFUSE) & valid, valid=valid)
        verts.append(v)
        if i == n_verts - 1:
            break
        u0, u1, u2 = uniform3(uid, _salt(i, slot), seed, o.dtype)
        wi, weight, pdf_b = _sample(sc, mat, n, -d, u0, u1, u2, radiance)
        if prev is not None:
            rev = _to_area(_pdf(sc, mat, n, wi, -d), p, prev.p, prev.ng)
            prev.pdf_rev = torch.where(valid, rev, prev.pdf_rev)
        beta = beta * weight
        side = torch.where(_dot(wi, n) >= 0, 1.0, -1.0).to(o.dtype)
        prev_p, prev = p, v
        o = p + n * (side * sc.eps)[:, None]
        d, pdf_sa = wi, pdf_b
        alive = valid & (beta.amax(-1) > 0)
    return verts


def eye_subpath(sc, cam, uid, r, seed):
    """The camera vertex, then the eye walk."""
    dt, n = sc.v0.dtype, uid.shape[0]
    W, H = r["width"], r["height"]
    pix = uid // r["spp"]
    j0, j1, _ = uniform3(uid, SLOT_CAMERA, seed, dt)
    u = ((pix % W).to(dt) + j0) * (1.0 / W)
    v = ((pix // W).to(dt) + j1) * (1.0 / H)
    d = _unit(cam.corner + u[:, None] * cam.du + v[:, None] * cam.dv
              - cam.o)
    o = cam.o.expand(n, 3)
    ones, zero = torch.ones_like(u), torch.zeros_like(u)
    cam_v = Vertex(p=o, ng=cam.fwd.expand(n, 3), wo=torch.zeros_like(d),
                   beta=torch.ones_like(d), pdf_fwd=ones, pdf_rev=zero,
                   mat=torch.zeros_like(pix), prim=torch.full_like(pix, -1),
                   delta=zero > 0, valid=ones > 0)
    return [cam_v] + _walk(sc, o, d, torch.ones_like(d), _cam_pdf(cam, d), o,
                           None, uid, seed, r["max_bounces"] + 1, SLOT_BSDF,
                           True)


def light_subpath(sc, uid, r, seed):
    """The point picked on an emitter, then the light walk."""
    dt = sc.v0.dtype
    E = sc.emit_tri.shape[0]
    u0, u1, u2 = uniform3(uid, _salt(0, SLOT_LIGHT_ORIGIN), seed, dt)
    li = (u0 * E).long().clamp_max(E - 1)
    lt = sc.emit_tri[li]
    su = torch.sqrt(u1)
    y = (sc.v0[lt] + (1.0 - su)[:, None] * sc.e1[lt]
         + (u2 * su)[:, None] * sc.e2[lt])
    n_l = sc.nrm[lt]
    pdf_a = 1.0 / (sc.emit_area[li] * E)
    le = sc.emission[sc.tri_mat[lt]]
    zero = torch.zeros_like(pdf_a)
    y0 = Vertex(p=y, ng=n_l, wo=torch.zeros_like(y),
                beta=le / pdf_a[:, None], pdf_fwd=pdf_a, pdf_rev=zero,
                mat=sc.tri_mat[lt], prim=lt, delta=zero > 0,
                valid=zero == 0)
    _, v1, v2 = uniform3(uid, _salt(0, SLOT_LIGHT_DIR), seed, dt)
    d0 = _cosine_dir(n_l, v1, v2)
    pdf_d0 = _dot(d0, n_l).clamp_min(0.0) / math.pi
    return [y0] + _walk(sc, y + n_l * sc.eps, d0, y0.beta * math.pi, pdf_d0,
                        y, y0, uid, seed, r["max_bounces"] + 1, SLOT_LBSDF,
                        False)


def mis_weight(sc, cam, ys, zs, s, t, power=False):
    """The weight of strategy (s, t): ys[s - 1] joined to zs[t - 1], or
    for s = 0 zs[t - 1] lying on an emitter."""
    fwd_z = [v.pdf_fwd for v in zs[:t]]
    rev_z = [v.pdf_rev for v in zs[:t]]
    fwd_y = [v.pdf_fwd for v in ys[:s]]
    rev_y = [v.pdf_rev for v in ys[:s]]
    z = zs[t - 1]
    if s == 0:
        rev_z[t - 1] = _emitter_pdf(sc, z.prim)[0]
        if t >= 2:
            cos_l = _dot(z.ng, z.wo).clamp_min(0.0)
            rev_z[t - 2] = _to_area(cos_l / math.pi, z.p, zs[t - 2].p,
                                    zs[t - 2].ng)
    else:
        y = ys[s - 1]
        d_zy = y.p - z.p
        d_zy = d_zy / torch.sqrt(_dot(d_zy, d_zy).clamp_min(1e-12))[:, None]
        d_yz = -d_zy
        sa = (_dot(y.ng, d_yz).clamp_min(0.0) / math.pi if s == 1
              else _pdf(sc, y.mat, y.ng, y.wo, d_yz))
        rev_z[t - 1] = _to_area(sa, y.p, z.p, z.ng)
        if t >= 2:
            rev_z[t - 2] = _to_area(_pdf(sc, z.mat, z.ng, d_zy, z.wo), z.p,
                                    zs[t - 2].p, zs[t - 2].ng)
        sa = (_cam_pdf(cam, d_zy) if t == 1
              else _pdf(sc, z.mat, z.ng, z.wo, d_zy))
        rev_y[s - 1] = _to_area(sa, z.p, y.p, y.ng)
        if s >= 2:
            rev_y[s - 2] = _to_area(_pdf(sc, y.mat, y.ng, d_yz, y.wo), y.p,
                                    ys[s - 2].p, ys[s - 2].ng)

    def remap(x):
        return torch.where(x > 0, x, 1.0)

    total = torch.zeros_like(z.pdf_fwd)
    ratio = torch.ones_like(total)
    for i in range(t - 1, 0, -1):
        ratio = ratio * remap(rev_z[i]) / remap(fwd_z[i])
        ok = ~zs[i].delta & ~zs[i - 1].delta
        total = total + torch.where(ok, ratio * ratio if power else ratio, 0)
    ratio = torch.ones_like(total)
    for i in range(s - 1, -1, -1):
        ratio = ratio * remap(rev_y[i]) / remap(fwd_y[i])
        ok = ~ys[i].delta
        if i > 0:
            ok = ok & ~ys[i - 1].delta
        total = total + torch.where(ok, ratio * ratio if power else ratio, 0)
    return 1.0 / (1.0 + total)


def _occluded(sc, o, d, tmax):
    t, tri, sph = pt.intersect(sc, o, d, tmax)
    return (tri >= 0) | (sph >= 0)


def radiance(sc, cam, uid, r, seed, splat, power=False):
    """The s = 0 and t >= 2 radiance (n, 3) of paths ``uid``; their t = 1
    splats are added into ``splat``, (H W + 1, 3) over the pixel ids
    counted from the bottom row, its last row taking the masked lanes."""
    W, H = r["width"], r["height"]
    zs = eye_subpath(sc, cam, uid, r, seed)
    ys = light_subpath(sc, uid, r, seed)
    V = r["max_bounces"] + 2
    L = torch.zeros_like(zs[0].beta)
    for t in range(2, V + 1):                       # s = 0
        z = zs[t - 1]
        le = torch.where((_dot(-z.wo, z.ng) < 0)[:, None],
                         sc.emission[z.mat], 0.0)
        on_light = z.valid & _emitter_pdf(sc, z.prim)[1]
        w = mis_weight(sc, cam, [], zs, 0, t, power)
        L = L + torch.where(on_light[:, None], z.beta * le * w[:, None], 0.0)
    for t in range(2, V + 1):                       # s >= 1, t >= 2
        for s in range(1, V - t + 1):
            y, z = ys[s - 1], zs[t - 1]
            d = y.p - z.p
            dist2 = _dot(d, d).clamp_min(1e-12)
            dist = torch.sqrt(dist2)
            d_zy = d / dist[:, None]
            f_z = _eval(sc, z.mat, z.ng, z.wo, d_zy)
            f_y = ((_dot(y.ng, -d_zy) > 0).to(d.dtype)[:, None] if s == 1
                   else _eval(sc, y.mat, y.ng, y.wo, -d_zy))
            G = _dot(z.ng, d_zy).abs() * _dot(y.ng, -d_zy).abs() / dist2
            c = z.beta * f_z * f_y * y.beta * G[:, None]
            want = (z.valid & y.valid & ~z.delta & ~y.delta
                    & (c.amax(-1) > 0))
            occ = _occluded(sc, z.p + _facing(z.ng, d_zy) * sc.eps, d_zy,
                            torch.where(want, dist * (1.0 - 1e-3), 0.0))
            w = mis_weight(sc, cam, ys, zs, s, t, power)
            L = L + torch.where((want & ~occ)[:, None], c * w[:, None], 0.0)
    n = uid.shape[0]
    du2 = _dot(cam.du, cam.du).clamp_min(1e-20)
    dv2 = _dot(cam.dv, cam.dv).clamp_min(1e-20)
    for s in range(1, V):                           # t = 1
        y = ys[s - 1]
        d = y.p - cam.o
        dist2 = _dot(d, d).clamp_min(1e-12)
        dist = torch.sqrt(dist2)
        d_cy = d / dist[:, None]
        cos_c = _dot(d_cy, cam.fwd)
        rel = d_cy / cos_c.clamp_min(1e-6)[:, None] - (cam.corner - cam.o)
        px = torch.floor((_dot(rel, cam.du) / du2 * W).clamp(-1.0, W)).long()
        py = torch.floor((_dot(rel, cam.dv) / dv2 * H).clamp(-1.0, H)).long()
        on_film = ((px >= 0) & (px < W) & (py >= 0) & (py < H)
                   & (cos_c > 1e-6))
        f_y = ((_dot(y.ng, -d_cy) > 0).to(d.dtype)[:, None] if s == 1
               else _eval(sc, y.mat, y.ng, y.wo, -d_cy))
        imp = (W * H) / (cam.area * cos_c.clamp_min(1e-6) ** 3)
        c = y.beta * f_y * (imp * _dot(y.ng, d_cy).abs() / dist2)[:, None]
        want = y.valid & ~y.delta & on_film & (c.amax(-1) > 0)
        occ = _occluded(sc, cam.o.expand(n, 3), d_cy,
                        torch.where(want, dist * (1.0 - 1e-3), 0.0))
        want = want & ~occ
        w = mis_weight(sc, cam, ys, zs, s, 1, power)
        splat.index_add_(0, torch.where(want, py * W + px, W * H),
                         torch.where(want[:, None], c * w[:, None], 0.0))
    return L


def render_image(sc, cam, r, seed, power=False, chunk=1 << 18):
    """The (H, W, 3) film, row 0 = top: in blocks of whole pixels of about
    ``chunk`` paths.  ``cam`` is ``pt.camera``'s tuple."""
    W, H, spp = r["width"], r["height"], r["spp"]
    cam = camera(cam)
    dev, dt = sc.v0.device, sc.v0.dtype
    splat = torch.zeros((W * H + 1, 3), dtype=dt, device=dev)
    own = []
    step = max(1, chunk // spp)
    with torch.no_grad():
        for p0 in range(0, W * H, step):
            pix = torch.arange(p0, min(p0 + step, W * H), device=dev)
            uid = (pix[:, None] * spp
                   + torch.arange(spp, device=dev)[None]).reshape(-1)
            L = radiance(sc, cam, uid, r, seed, splat, power)
            own.append(L.reshape(-1, spp, 3).mean(dim=1))
    film = torch.cat(own) + splat[:W * H] / float(W * H * spp)
    return film.reshape(H, W, 3).flip(0)
