"""Ring-connection BDPT over the world, port of ``tputracer/dist/bdpt_ring.py``.

DP BDPT (``dist.mesh.render_bdpt_sharded``) joins each eye subpath to its
own light subpath only.  Here the light subpaths are sharded with the
rays, and each rank's block of light vertices goes round the ring: after
P - 1 hops every eye subpath has been joined to P independent light
subpaths, with constant memory a rank.

Estimator: the (s >= 1, t >= 2) connection strategies average over the P
light-subpath partners, each an unbiased sample of the same integrals;
the s = 0 strategies depend on the eye walk only and the t = 1 splats on
the local light walk only, so both run once.  The MIS weights are per
(eye, light) pair and unchanged.  It is plain BDPT's integral with P
connection samples an eye path.
"""

from __future__ import annotations

import torch

from tputracer_torch.dist.mesh import (_check_divisible, gather_image,
                                       own_splat_rows, pack, ring_shift,
                                       shard_uids, unpack)
from tputracer_torch.integrators.bdpt import (connection_radiance,
                                              eye_subpaths, light_subpaths,
                                              s0_radiance, t1_splats)
from tputracer_torch.integrators.pt import film_from_radiance


def _shift_vertices(ys, mesh):
    """The light-vertex block of shard rank - 1: one hop of the ring, every
    vertex's every field in one packed buffer."""
    flat = [v[k] for v in ys for k in sorted(v)]
    out = iter(unpack(ring_shift(pack(flat), mesh), flat))
    return [{k: next(out) for k in sorted(v)} for v in ys]


def ring_bdpt_radiance(scene, uids, cfg, mesh):
    """This shard's BDPT radiance with the light-subpath blocks going
    round the ring.  Returns (L_own (n,3), splat (H*W,3)): the splat is
    this shard's own, which the caller all-reduces."""
    zs = eye_subpaths(scene, uids, cfg)
    ys = light_subpaths(scene, uids, cfg)
    L = s0_radiance(scene, cfg, zs)
    splat = t1_splats(scene, cfg, ys, zs)
    conn = torch.zeros_like(L)
    for r in range(mesh.size):
        if r > 0:
            ys = _shift_vertices(ys, mesh)
        conn = conn + connection_radiance(scene, cfg, ys, zs)
    return L + conn / float(mesh.size), splat


def emulate_ring_bdpt(scene, uids, cfg, n_shards):
    """The ring estimator of ``n_shards`` shards in one process: after r
    hops shard p holds the light block of shard p - r, a roll by r
    blocks along the path axis.  The oracle of the ring."""
    n = uids.shape[0]
    n_loc = n // n_shards
    if n_loc * n_shards != n:
        raise ValueError(f"{n} paths do not split into {n_shards} shards")
    zs = eye_subpaths(scene, uids, cfg)
    ys = light_subpaths(scene, uids, cfg)
    L = s0_radiance(scene, cfg, zs)
    splat = t1_splats(scene, cfg, ys, zs)
    conn = torch.zeros_like(L)
    for r in range(n_shards):
        ys_r = [{k: torch.roll(x, r * n_loc, dims=0) for k, x in v.items()}
                for v in ys]
        conn = conn + connection_radiance(scene, cfg, ys_r, zs)
    return L + conn / float(n_shards), splat


def render_bdpt_ring(scene, cfg, mesh):
    """Full-frame ring-connection BDPT render over the mesh -> (H,W,3),
    row 0 = top, on every shard.  Each eye subpath joins P light
    subpaths; it converges to ``api.render_bdpt``'s image with about 1/P
    of its connection variance."""
    rows_per = _check_divisible(cfg, mesh.size)
    n_total = cfg.width * cfg.height * cfg.spp
    L_own, splat = ring_bdpt_radiance(
        scene, shard_uids(cfg, mesh, scene.device), cfg, mesh)
    img = film_from_radiance(L_own, cfg, rows=rows_per, flip=False)
    img = img + own_splat_rows(splat, cfg, mesh, rows_per) / float(n_total)
    return gather_image(img, mesh)
