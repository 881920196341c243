"""Scene tiling over the world, port of ``tputracer/dist/scene_shard.py``.

DP (``dist.mesh``) replicates the whole scene on every rank.  For a scene
that outgrows one card, or one kernel launch, the cluster-major geometry
is instead split: each rank holds C/P clusters, a contiguous slice of the
triangle tables and their boxes (:func:`shard_scene`).  Rays then cross
the whole scene by going round a ring: each rank walks its resident ray
block through its own clusters, then sends the rays with their running
best hit to the next rank; after P hops every ray is home with the global
nearest hit.  Per-rank memory stays constant in P, and no geometry moves.

The local walk on each hop is ``accel.traverse_cuda.traverse``: kernel B2
(``csrc/traverse.cu``) on the card, the clustered walk on the CPU.  It
takes the previous hops' best as its carry (``bt0 = min(best_t, tmax)``,
``bp0 = -1``), so B2 launches once a hop, P times an intersection call,
each on C/P clusters.  B2 stages every cluster box of its scene in one
block's shared memory; a ring of P ranks walks scenes up to P times that.

Everything but the triangle tables and cluster boxes (materials, emitter
tables, spheres, camera) stays whole on every rank.  The hit carry holds
the global primitive id and the normal and material fetched while the
owning shard was resident, so shading never touches a remote shard.
Spheres are resolved once, on the home hop, as the ring's initial best.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from tputracer_torch import geometry as g
from tputracer_torch.accel.bruteforce import Hit
from tputracer_torch.accel.clustered import _sphere_best, traverse_args
from tputracer_torch.accel.intersect_cuda import _rays
from tputracer_torch.accel.toptree import top_boxes
from tputracer_torch.dist.mesh import (_bdpt_rows, _pt_rows, fit_step_rows,
                                       gather_image, pack, ring_shift,
                                       sum_stats, unpack)
from tputracer_torch.lookup import fetch, fetch_int
from tputracer_torch.trace import span

_BIG = 3.0e38

# the Scene fields split over the ranks: the triangle tables (leading
# axis, cluster-major slots), plu (last axis) and the cluster boxes
TRI_FIELDS = ("tri_v0", "tri_e1", "tri_e2", "tri_n", "tri_mat", "tri_mask")


def pad_scene_clusters(scene, n_shards):
    """Pad the cluster tables so C divides n_shards: clusters whose boxes
    sit at 3e38 (never entered) and whose slots are masked zeros.  The
    spheres need no padding: they stay whole on every rank."""
    C = scene.n_clusters
    if C == 0:
        raise ValueError("scene tiling needs a clustered scene")
    Cp = -(-C // n_shards) * n_shards
    if Cp == C:
        return scene
    padc, padt = Cp - C, (Cp - C) * scene.leaf_size

    def rows(x, n, fill=0.0):
        return torch.cat([x, torch.full((n,) + tuple(x.shape[1:]), fill,
                                        dtype=x.dtype, device=x.device)])

    kw = {f: rows(getattr(scene, f), padt) for f in TRI_FIELDS}
    return dataclasses.replace(
        scene, **kw,
        plu=torch.cat([scene.plu, scene.plu.new_zeros((3, 6, padt))], dim=2),
        **_boxes(rows(scene.clus_min, padc, _BIG),
                 rows(scene.clus_max, padc, _BIG)))


def _boxes(cmin, cmax):
    """The Scene fields of these cluster boxes and of their top level."""
    top_min, top_max = top_boxes(cmin, cmax)
    return dict(clus_min=cmin, clus_max=cmax, top_min=top_min,
                top_max=top_max)


def shard_scene(scene, rank, n_shards):
    """Rank ``rank``'s tile of a scene whose cluster count divides
    n_shards (:func:`pad_scene_clusters`): its C/P clusters' triangle
    slots, Pluecker columns and boxes, and the top level over those
    boxes; every other field whole.  Slices
    of the given tensors: ``.to(device)`` moves only the tile."""
    Cl = scene.n_clusters // n_shards
    if Cl * n_shards != scene.n_clusters:
        raise ValueError(f"{scene.n_clusters} clusters do not split into "
                         f"{n_shards} shards; pad_scene_clusters first")
    c0, c1 = rank * Cl, (rank + 1) * Cl
    t0, t1 = c0 * scene.leaf_size, c1 * scene.leaf_size
    kw = {f: getattr(scene, f)[t0:t1] for f in TRI_FIELDS}
    return dataclasses.replace(
        scene, **kw, plu=scene.plu[:, :, t0:t1].contiguous(),
        **_boxes(scene.clus_min[c0:c1], scene.clus_max[c0:c1]))


def geometry_bytes(scene):
    """Bytes of the fields :func:`shard_scene` splits."""
    return sum(getattr(scene, f).nbytes
               for f in TRI_FIELDS + ("plu", "clus_min", "clus_max"))


def _local_best(args, o, d, tmin, tmax, bt, leaf, any_hit):
    """Nearest (or any) hit of rays in the resident shard, whose walk
    tables are ``args`` (``traverse_args``): (t, local prim).  On a miss
    t is the carry min(bt, tmax) unchanged, so callers detect a better
    hit by t < bt (strict)."""
    from tputracer_torch.accel.traverse_cuda import traverse

    bp0 = torch.full(o.shape[:1], -1, dtype=torch.int32, device=o.device)
    return traverse(o, d, tmin, tmax, torch.minimum(bt, tmax), bp0, *args,
                    leaf=leaf, any_hit=any_hit)


def make_ring_backends(mesh, comm_log=None, hop_log=None):
    """(intersect_ring, occluded_ring): intersection hooks with the
    signatures of ``accel.intersect`` / ``accel.occluded`` (what
    ``trace_radiance`` and ``trace_bdpt`` take), for a scene that is this
    rank's tile (:func:`shard_scene`).  Every rank must call them the same
    number of times with the same ray count, as the integrators do.

    The state crosses each hop as one int32 buffer (``mesh.pack``): 14
    words a ray for the closest hit (o 3, d 3, tmin, tmax, best t, global
    prim, best normal 3, material) and 8 for occlusion (o 3, d 3, tmax,
    occluded).  Every lane rides, dead ones too (their tmax = 0 skips the
    walk).  P hops bring the rays home; with P = 1 nothing is sent.

    comm_log: a list; each call appends the bytes this rank sends over
    the ring (the buffer's bytes times P hops, 0 when P = 1): the stat
    ``ring_ppermute_bytes_per_device``.  Under gloo with CUDA tensors the
    same bytes also cross to the host and back on each hop, explicitly
    (``mesh.ring_shift``).
    hop_log: a list; when given, each hop synchronizes the card before it
    and after it and appends its seconds (its ``dist.ring_hop`` span's,
    host clock): the time in the hops, without the kernels queued before
    them.
    """
    P = mesh.size

    def go_round(state, walk_hop):
        """P hops: walk the resident rays, then send them on."""
        if comm_log is not None:
            words = sum(math.prod(t.shape[1:]) for t in state)
            comm_log.append(0 if P == 1 else 4 * words * len(state[0]) * P)
        for _ in range(P):
            state = walk_hop(state)
            if P > 1:
                state = hop(state)
        return state

    def hop(state):
        buf = pack(state)
        sync = hop_log is not None and buf.is_cuda
        if sync:
            torch.cuda.synchronize(buf.device)
        with span("dist.ring_hop") as rec:
            out = unpack(ring_shift(buf, mesh), state)
            if sync:
                torch.cuda.synchronize(buf.device)
        if hop_log is not None:
            hop_log.append(rec.ms / 1e3)
        return out

    def intersect_ring(scene, o, d, tmin, tmax):
        od, dd, tn, tx = _rays(o, d, tmin, tmax)
        n, T_loc = od.shape[0], scene.n_tri_pad
        args = traverse_args(scene)
        best_t = tx.clone()
        best_g = torch.full((n,), -1, dtype=torch.int32, device=od.device)
        best_n = torch.zeros((n, 3), dtype=torch.float32, device=od.device)
        best_m = torch.zeros((n,), dtype=torch.int32, device=od.device)
        with torch.no_grad():
            if scene.n_spheres:
                # the spheres are whole on every rank: resolve them once,
                # at home, as the initial best; global id P*T_loc + j,
                # above every tiled triangle's, as finalize_hit numbers
                # them after the scene's triangle slots
                st, sp = _sphere_best(scene, od, dd, tn, tx)
                imp = st < best_t
                j = torch.where(imp, sp - T_loc, 0).long()
                p_s = od + torch.where(imp, st, 1.0)[:, None] * dd
                n_s = ((p_s - fetch(scene.sph_c, j))
                       / fetch(scene.sph_r, j)[:, None])
                best_t = torch.where(imp, st, best_t)
                best_g = torch.where(imp, sp + (P - 1) * T_loc, best_g)
                best_n = torch.where(imp[:, None], n_s, best_n)
                best_m = torch.where(imp, fetch_int(scene.sph_mat, j), best_m)

            def walk_hop(state):
                od, dd, tn, tx, best_t, best_g, best_n, best_m = state
                t, lprim = _local_best(args, od, dd, tn, tx, best_t,
                                       scene.leaf_size, any_hit=False)
                imp = t < best_t
                lp = torch.where(imp, lprim, 0).long()
                # fetch the hit's normal (normalized as finalize_hit
                # does) and material while the owning shard is resident;
                # the prim lives here, on shard mesh.rank
                best_g = torch.where(imp, mesh.rank * T_loc + lprim, best_g)
                best_n = torch.where(imp[:, None],
                                     g.normalize(fetch(scene.tri_n, lp)),
                                     best_n)
                best_m = torch.where(imp, fetch_int(scene.tri_mat, lp), best_m)
                best_t = torch.where(imp, t, best_t)
                return [od, dd, tn, tx, best_t, best_g, best_n, best_m]

            best_t, best_g, best_n, best_m = go_round(
                [od, dd, tn, tx, best_t, best_g, best_n, best_m],
                walk_hop)[4:]
        valid = best_t < tx
        return Hit(
            t=best_t,
            prim=torch.where(valid, best_g, -1),
            valid=valid,
            p=o + torch.where(valid, best_t, 1.0)[:, None] * d,
            n=torch.where(valid[:, None], best_n, 0.0),
            mat=torch.where(valid, best_m, 0),
        )

    def occluded_ring(scene, o, d, tmax):
        od, dd, _, tx = _rays(o, d, torch.zeros_like(tmax), tmax)
        zero = torch.zeros_like(tx)
        args = traverse_args(scene)
        with torch.no_grad():
            occ = torch.zeros(tx.shape, dtype=torch.bool, device=tx.device)
            if scene.n_spheres:
                # spheres occlude at home; occluded lanes then ride the
                # ring with tmax = 0, which skips their walk
                occ = _sphere_best(scene, od, dd, zero, tx)[0] < tx

            def walk_hop(state):
                od, dd, tx, occ = state
                live = torch.where(occ, 0.0, tx)
                t, _ = _local_best(args, od, dd, zero, live, live,
                                   scene.leaf_size, any_hit=True)
                return [od, dd, tx, occ | (t < tx)]

            return go_round([od, dd, tx, occ], walk_hop)[3]

    return intersect_ring, occluded_ring


def _tile(scene, mesh, device=None):
    """This rank's tile of the scene, padded for the mesh, on ``device``
    (None: the scene's device)."""
    sc = shard_scene(pad_scene_clusters(scene, mesh.size), mesh.rank,
                     mesh.size)
    return sc if device is None else sc.to(device)


def render_tiled(scene, cfg, mesh, device=None):
    """Full-frame path-traced render with the geometry tiled over the mesh
    (C/P clusters a rank) and rays going round the ring past every tile.

    device: where the tile renders (None: the scene's device); only the
    tile goes there, so a scene built on the host can exceed one card's
    share.  Returns (image (H,W,3), row 0 = top, stats), on every rank;
    stats are the replicated render's, summed over the mesh, plus
    ``ring_ppermute_bytes_per_device`` (the bytes each rank sent over the
    ring, see :func:`make_ring_backends`) and ``ring_hops_per_traversal``
    (P).  The image matches ``api.render``'s up to hits tied at equal t
    in different shards."""
    sc = _tile(scene, mesh, device)
    comm_log = []
    img, stats = _pt_rows(sc, cfg, mesh,
                          *make_ring_backends(mesh, comm_log=comm_log))
    stats = dict(sum_stats(stats, mesh),
                 ring_ppermute_bytes_per_device=torch.tensor(
                     float(sum(comm_log)), device=sc.device),
                 ring_hops_per_traversal=torch.tensor(
                     mesh.size, dtype=torch.int32, device=sc.device))
    return gather_image(img, mesh), stats


def render_bdpt_tiled(scene, cfg, mesh, device=None):
    """Full-frame BDPT render with the geometry tiled over the mesh: both
    subpath walks, the connections' and the t=1 splats' shadow rays go
    round the ring.  ``device`` as in :func:`render_tiled`.  Matches
    ``api.render_bdpt`` up to the order of the splat's sums."""
    sc = _tile(scene, mesh, device)
    isect, occl = make_ring_backends(mesh)
    return gather_image(_bdpt_rows(sc, cfg, mesh, isect, occl), mesh)


def _tiled_step(tile, params, target, cfg, mesh):
    hooks = make_ring_backends(mesh)
    return fit_step_rows(tile, params, target, cfg, mesh,
                         lambda sc: _pt_rows(sc, cfg, mesh, *hooks)[0])


def fit_step_tiled(scene, params, target, cfg, mesh):
    """One inverse-rendering step with the geometry tiled over the mesh:
    (loss, grads), summed over the mesh.  params are material or light
    tables (whole on every rank; the walk is detached, so the geometry
    takes no gradient).  Matches :func:`dist.mesh.fit_step_sharded`:
    the same hits, the same RNG, the same shading."""
    return _tiled_step(_tile(scene, mesh), params, target, cfg, mesh)


def fit_chain_tiled(scene, params, target, cfg, mesh, opt, n_steps):
    """n_steps optimizer steps of :func:`fit_step_tiled` on one tile:
    (n_steps,) losses, params updated in place."""
    from tputracer_torch.fit import chain_steps

    return chain_steps(
        lambda sc, p, t: _tiled_step(sc, p, t, cfg, mesh),
        _tile(scene, mesh), params, target, opt, n_steps)
