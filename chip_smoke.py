#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tputracer_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each printing one line:

  1. device: needs torch.cuda; prints the card's name and power limit.
  2. build: compiles the three sources of tputracer_torch/csrc/ (one nvcc
     per source, started together) and builds the config-3 mesh scene on
     the card, saying which BVH builder (native or NumPy) ran.
  3. kernel: the intersection kernel against its plain PyTorch version,
     bit for bit (t and prim, or the occlusion booleans with any hit), on
     2^20 random rays (Cornell boxes and spheres, closest and any hit, a
     quarter of the lanes dead) and a ragged count; the closest-hit and
     shadow rays of bounce 2 of config 1's first chunk (2^20 paths),
     recorded through render's hooks; a mask with holes, every hit tied
     with a copy at a higher slot across masked slots; an unclustered soup
     of 2,048 triangles (several staged tiles); 300 spheres (several sphere
     tiles); rays that are all dead.  Each set's live share, the kernel
     and plain times and the bound.
  4. render: the config-1 path, tputracer_torch.api.render of Cornell boxes
     at 512x512, 16 spp, 4 bounces; it must launch the intersection kernel
     36 times (4 chunks x (5 closest + 4 shadow)) and give a sane image.
     Timed with the kernel and with the plain version in its place.
  5. parity: a 64x64, 4 spp render with the kernel against the same render
     with the plain version on the card, and against the CPU render.
  6. traverse: the traversal kernel against its plain version (the
     clustered walk), bit for bit (t and prim), on the 102,410-triangle
     mesh at 2^16 rays (one config-3 chunk): camera rays and random rays
     from inside the room, closest and any hit; rays that start on cluster
     box faces, so entries tie at te = +-0; the pair route's fallback input
     (its unresolved rays first, the rest at tmax = 0); deep walks through
     a soup of large triangles at config 3's widths, where every ray admits
     more than 4 x 32 clusters, so the lanes refill their buffers; a
     ragged count; a scene with spheres and 16-slot leaves.  Timed beside
     the plain version and the bound; the clusters each ray admits and
     enters.
  7. mesh render: the config-3 path, api.render of mesh_scene(subdiv=6) at
     256x256, 4 spp, 8 bounces; it must launch the traversal kernel 68
     times (4 chunks x (9 closest + 8 shadow)), the intersection kernel
     never, and give a sane image.  Timed with the kernel, and once with
     the plain walk in its place.
  8. mesh parity: mesh_scene(subdiv=4) at 32x32, 4 spp, 8 bounces with the
     kernel, with the plain walk on the card, and on the CPU.
  9. pairs: the expand and pair-test kernels (the pair route) against their
     plain versions, bit for bit, on the 102,410-triangle mesh at 2^16
     camera rays and at 2^16 and 2^18 random rays, closest and any hit; a
     ragged count; Cornell "spheres" in 16-slot clusters.  The whole route
     against the traversal kernel: prims equal except at ties, occlusion
     equal.  Timed at 2^16 and 2^18 rays: expand, pair test, the route and
     the traversal kernel, each beside its bound; the share of live rays
     the K slots resolve.
 10. pairs render: the config-3 render of phase 7 with TPUTRACER_PAIRS=1
     (set for this phase only); it must launch the expand, pair-test and
     traversal kernels 68 times each, the intersection kernel never, give
     a mean in [0.20, 0.30] and match the default route's image at the
     golden tolerances.  Timed in turns with the default route.

A kernel's ``ms`` times one call alone between CUDA events, the wrapper's
host work included (cuda_ms: the median of 5 after 2 warm-ups);
``device_ms`` is the card's time per call over 20 calls back to back.

Then a JSON line of per-kernel results (each kernel's launches on its main
path, times, and bound: the larger of the bytes it must move over 3.35
TB/s and the float ops this run's data needs over 33.5 T ops/s, the
card's 67 TFLOP/s float32 rate without fused multiply-adds, which the
kernels are built without), the card's name and power limit, and last
{"ok": true, "device": {...}}.  Any failure raises and the script
exits non-zero without that last line; there is no CPU fallback.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

N_RAYS = 1 << 20
N_CHUNK = 1 << 16     # rays per traversal call in a config-3 render
BIG = 3.0e38
# BASELINE config 3 (benchmarks/run.py): mesh_scene(subdiv=6)
MESH_CFG = dict(width=256, height=256, spp=4, max_bounces=8, rr_start=3,
                chunk_size=1 << 16)


# the H100's float32 rate without fused multiply-adds (its 67 TFLOP/s
# counts an FMA as two ops) and its memory rate (SXM data sheet)
PEAK_OPS = 33.5e12
PEAK_BYTES = 3.35e12
# float ops of one test, counted from the CUDA sources: a cluster slab
# (6 sub, 6 mul, 12 min/max, 4 compares); a Pluecker + plane triangle test
# (three 6-term dots, 6 sign compares, two 3-term dots, 6 more), of which
# the edge part (the dots and compares, OPS_EDGES) is needed for every
# pair and the plane part only where the three edge signs agree; a
# Moeller-Trumbore test (csrc/pairs.cu); a sphere (csrc/intersect.cu)
OPS_SLAB = 26
OPS_PLANE = 56
OPS_EDGES = 39
OPS_MT = 55
OPS_SPHERE = 24


def bound(ops, nbytes):
    """(bound_ms, bound_by): the least time for this work on the card."""
    t_ops, t_bytes = ops / PEAK_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def cuda_ms(fn, warmup, reps):
    """Median milliseconds of fn() between CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps=20):
    """Milliseconds of the card per call of fn: ``reps`` calls back to back
    between two CUDA events, after two warm-up calls.  The host's work for
    a call overlaps the card's work on the one before, so this is the
    card's time wherever a call keeps the card busier than the host; a
    single call between events (cuda_ms) also counts the wrapper's host
    work while the card waits."""
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_device():
    check(torch.cuda.is_available(),
          "no CUDA device: this script measures the card and has no CPU run")
    card = card_line()
    print(card, flush=True)
    emit("device", kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    return card


def phase_build():
    from tputracer_torch import cuda_build
    from tputracer_torch.accel import bvh
    from tputracer_torch.accel import intersect_cuda as ic
    from tputracer_torch.accel import pairs_cuda as pc
    from tputracer_torch.accel import traverse_cuda as tc
    from tputracer_torch.scene import mesh_scene

    sources = ("intersect.cu", "traverse.cu", "pairs.cu")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:     # one nvcc per source, together
        for job in [pool.submit(m.load_kernel) for m in (ic, tc, pc)]:
            job.result()
    nvcc_s = time.perf_counter() - t0
    ptxas = {src: [ln.strip() for ln in
                   cuda_build.BUILD_LOG.get(src, "").splitlines()
                   if "registers" in ln or "spill" in ln]
             for src in sources}
    t0 = time.perf_counter()
    mesh = mesh_scene(subdiv=6, device="cuda")
    emit("build", seconds=round(nvcc_s, 3),
         nvcc_seconds={k: cuda_build.BUILD_SECONDS.get(k) for k in sources},
         ptxas=ptxas, bvh_builder=bvh.LAST_BUILDER, n_tris=mesh.n_tris,
         n_clusters=mesh.n_clusters, leaf_size=mesh.leaf_size,
         scene_seconds=round(time.perf_counter() - t0, 3))
    check(mesh.n_tris == 102_410, f"mesh has {mesh.n_tris} triangles")
    return mesh


def random_rays(n, seed):
    """Rays from inside the box in random directions; a quarter dead."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(0.02, 0.98, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.zeros(n, np.float32)
    tmax = np.full(n, BIG, np.float32)
    tmax[::4] = 0.0
    tocc = rng.uniform(0.0, 1.5, n).astype(np.float32)
    tocc[::4] = 0.0
    return tuple(torch.from_numpy(x).cuda()
                 for x in (o, d, tmin, tmax, tocc))


def box_soup(n_tris, n_spheres, seed):
    """make_scene's inputs (tri_vertices, tri_mat, materials, spheres) for a
    soup of n_tris triangles about 0.2 across and n_spheres spheres of
    radius 0.01 to 0.05, all in the unit box that random_rays start in.
    Up to 2,048 triangles make_scene leaves it unclustered."""
    rng = np.random.default_rng(seed)
    tv = (rng.uniform(0.0, 1.0, (n_tris, 1, 3))
          + rng.normal(0.0, 0.1, (n_tris, 3, 3))).astype(np.float32)
    spheres = [(tuple(rng.uniform(0.0, 1.0, 3)), float(rng.uniform(0.01, 0.05)),
                0) for _ in range(n_spheres)]
    materials = [{"kind": 0, "albedo": (0.5, 0.5, 0.5)}]   # diffuse
    return tv, np.zeros(n_tris, np.int32), materials, spheres


def holey_tables(seed, device="cuda"):
    """The kernel's tables (intersect_cuda.scene_args order) of a scene
    whose mask has holes: Cornell "boxes"' 36 triangles at random slots of
    the first 192 of 384, in their order, and an exact copy of each at a
    random slot of the last 192, so every hit ties with a copy at a higher
    index across masked slots.  The masked slots (mask 0 or -1) hold large
    random triangles that many rays would hit if the mask were ignored.
    No spheres."""
    from tputracer_torch.scene import cornell_box
    from tputracer_torch.scene.types import _pluecker_matrix

    rng = np.random.default_rng(seed)
    box = cornell_box("boxes", device="cpu")
    valid = np.flatnonzero(box.tri_mask.numpy() > 0)
    T, half = 384, 192
    junk = rng.uniform(-0.5, 1.5, (T, 3, 3)).astype(np.float32)
    plu = _pluecker_matrix(junk[:, 0], junk[:, 1], junk[:, 2])
    v0 = junk[:, 0].copy()
    n = np.cross(junk[:, 1] - junk[:, 0], junk[:, 2] - junk[:, 0])
    mask = np.where(rng.uniform(size=T) < 0.5, 0.0, -1.0).astype(np.float32)
    for slots, order in (
            (np.sort(rng.choice(half, valid.size, replace=False)), valid),
            (half + np.sort(rng.choice(half, valid.size, replace=False)),
             rng.permutation(valid))):
        plu[:, :, slots] = box.plu.numpy()[:, :, order]
        n[slots] = box.tri_n.numpy()[order]
        v0[slots] = box.tri_v0.numpy()[order]
        mask[slots] = 1.0
    return tuple(torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        device) for x in (np.zeros((0, 3)), np.zeros(0), plu, n, v0, mask))


def dead_rays(n, seed, device="cuda"):
    """(o, d, tmin, tmax, tocc) that no candidate can satisfy: tmax = tmin
    = 0 for half the rays, tmax < tmin for the rest, tocc = 0."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(0.02, 0.98, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.where(np.arange(n) % 2 == 1, 1.0, 0.0)
    tmax = np.where(np.arange(n) % 2 == 1, 0.5, 0.0)
    return tuple(torch.from_numpy(np.asarray(x, np.float32)).to(device)
                 for x in (o, d, tmin, tmax, np.zeros(n)))


def bounce_rays(scene, cfg, bounce):
    """The rays of bounce ``bounce`` of the first chunk of a render of
    ``scene`` at ``cfg``, recorded through trace_radiance's intersect_fn
    and occluded_fn hooks, which pass them on to accel.intersect and
    accel.occluded (the kernel on the card).  Returns the closest-hit rays
    (o, d, tmin, tmax) and the shadow rays (o, d, 0, tmax)."""
    from tputracer_torch.accel import intersect, occluded
    from tputracer_torch.integrators.pt import trace_radiance

    closest, shadow = [], []

    def keep(*xs):
        return tuple(x.clone(memory_format=torch.contiguous_format)
                     for x in xs)

    def isect(sc, o, d, tmin, tmax):
        closest.append(keep(o, d, tmin, tmax))
        return intersect(sc, o, d, tmin, tmax)

    def occl(sc, o, d, tmax):
        shadow.append(keep(o, d, torch.zeros_like(tmax), tmax))
        return occluded(sc, o, d, tmax)

    n = min(cfg.chunk_size, cfg.width * cfg.height * cfg.spp)
    uid = torch.arange(n, dtype=torch.int64, device=scene.device)
    trace_radiance(scene, uid, cfg, intersect_fn=isect, occluded_fn=occl)
    return closest[bounce], shadow[bounce]


def intersect_bound(o, d, live, args):
    """(bound_ms, bound_by, agree_share) of a closest-hit call on this
    data: every live ray tests every sphere and runs the edge part of
    every valid triangle's test, and the plane part only where the three
    edge signs agree, as the plain version's pos | neg mask says on the
    same inputs; each ray's 40 bytes and each table read once.
    agree_share: the share of (live ray, valid triangle) pairs whose signs
    agree."""
    from tputracer_torch.accel.bruteforce import edge_volume, ray_features

    sph_c, plu, mask = args[0], args[2], args[5]
    valid = mask > 0
    feat = ray_features(o[live], d[live])
    agree = 0
    for b0 in range(0, plu.shape[2], 128):   # the plain version's blocks
        sl = slice(b0, b0 + 128)
        w0, w1, w2 = (edge_volume(feat, plu[e, :, sl].T) for e in range(3))
        pos = (w0 >= 0.0) & (w1 >= 0.0) & (w2 >= 0.0)
        neg = (w0 <= 0.0) & (w1 <= 0.0) & (w2 <= 0.0)
        agree += int(((pos | neg) & valid[sl]).sum())
    n_live = float(live.sum())
    pairs = n_live * float(valid.sum())
    ops = (pairs * OPS_EDGES + agree * (OPS_PLANE - OPS_EDGES)
           + n_live * sph_c.shape[0] * OPS_SPHERE)
    return (*bound(ops, 40 * live.numel() + 4 * sum(x.numel() for x in args)),
            agree / pairs if pairs else 0.0)


def intersect_case(name, rays, args, any_hit=False, timed=True):
    """The intersection kernel against its plain version on one ray set
    (o, d, tmin, tmax), scene and mode, bit for bit: t and prim, and with
    any_hit the occlusion booleans.  With ``timed``, the kernel (cuda_ms
    and device_ms) and the plain version timed, and closest hit's bound."""
    from tputracer_torch.accel import intersect_cuda as ic

    o, d, tmin, tmax = rays
    n = o.shape[0]

    def kernel():
        return ic.fused_intersect_cuda(o, d, tmin, tmax, *args,
                                       any_hit=any_hit)

    def plain():
        return ic.fused_intersect_plain(o, d, tmin, tmax, *args)

    (t_k, p_k), (t_p, p_p) = kernel(), plain()
    torch.cuda.synchronize()
    live = tmax > tmin
    res = {"set": name, "n_rays": n, "mode": "any" if any_hit else "closest",
           "live_share": float(live.float().mean()) if n else 0.0}
    if any_hit:
        mism = {"occluded": int(((t_k < tmax) != (t_p < tmax)).sum())}
        res["occluded_share"] = float((t_p < tmax).float().mean())
        max_abs = 0.0
    else:
        mism = {"prim": int((p_k != p_p).sum()),
                "t": int((t_k.view(torch.int32)
                          != t_p.view(torch.int32)).sum())}
        max_abs = float((t_k - t_p).abs().max()) if n else 0.0
        miss = p_k < 0   # a miss reports t = tmax
        mism["miss_t"] = int((t_k[miss].view(torch.int32)
                              != tmax[miss].view(torch.int32)).sum())
        res["hit_share"] = float((p_p >= 0).float().mean())
        res["bound_ms"], res["bound_by"], res["agree_share"] = \
            intersect_bound(o, d, live, args)
    res.update(mismatch=mism, max_abs_err=max_abs)
    check(sum(mism.values()) == 0,
          f"intersect {name} {res['mode']}: the kernel differs from the "
          f"plain version {mism}")
    if timed:
        res["ms"] = cuda_ms(kernel, 2, 5)
        res["device_ms"] = device_ms(kernel)
        res["plain_ms"] = cuda_ms(plain, 1, 3)
    return res


def intersect_sets():
    """The ray sets and scenes of phase 3 (and of chip_profile.py's B1
    timing): a list of (name, rays (o, d, tmin, tmax), kernel tables,
    any_hit, timed), the first the main case (boxes, closest hit)."""
    from tputracer_torch.accel import intersect_cuda as ic
    from tputracer_torch.config import RenderConfig
    from tputracer_torch.scene import cornell_box, make_scene

    o, d, tmin, tmax, tocc = random_rays(N_RAYS, seed=1234)
    zero = torch.zeros_like(tocc)
    sets = []
    for variant in ("boxes", "spheres"):
        args = ic.scene_args(cornell_box(variant, device="cuda"))
        sets += [(f"{variant}, random", (o, d, tmin, tmax), args, False, True),
                 (f"{variant}, random", (o, d, zero, tocc), args, True, True),
                 (f"{variant}, ragged 1000",
                  (o[:1000], d[:1000], tmin[:1000], tmax[:1000]), args,
                  False, False)]
    # a real render's dead-lane pattern: config 1's first chunk, bounce 2
    boxes = cornell_box("boxes", device="cuda")
    cfg = RenderConfig(width=512, height=512, spp=16, max_bounces=4)
    closest, shadow = bounce_rays(boxes, cfg, 2)
    args = ic.scene_args(boxes)
    sets += [("boxes, bounce 2", closest, args, False, True),
             ("boxes, bounce 2 shadow", shadow, args, True, True)]
    holey = holey_tables(seed=31)
    sets += [("holes and ties", (o, d, tmin, tmax), holey, False, True),
             ("holes and ties", (o, d, zero, tocc), holey, True, True)]
    q = 1 << 18
    soup = ic.scene_args(make_scene(*box_soup(2048, 0, seed=32),
                                    device="cuda"))
    sets += [("soup 2048", (o[:q], d[:q], tmin[:q], tmax[:q]), soup, False,
              True),
             ("soup 2048", (o[:q], d[:q], zero[:q], tocc[:q]), soup, True,
              True)]
    q = 1 << 16
    balls = ic.scene_args(make_scene(*box_soup(300, 300, seed=33),
                                     device="cuda"))
    sets += [("300 spheres", (o[:q], d[:q], tmin[:q], tmax[:q]), balls,
              False, True),
             ("300 spheres", (o[:q], d[:q], zero[:q], tocc[:q]), balls,
              True, False)]
    dead = dead_rays(N_RAYS, seed=34)
    args = ic.scene_args(boxes)
    sets += [("all dead", dead[:4], args, False, True),
             ("all dead", (*dead[:2], zero, dead[4]), args, True, False)]
    return sets


def phase_kernel():
    """The intersection kernel against its plain version, bit for bit, on
    every set of intersect_sets; each set's live share, times and bound."""
    results = []
    for name, rays, args, any_hit, timed in intersect_sets():
        res = intersect_case(name, rays, args, any_hit, timed)
        if name == "all dead":
            check(res["live_share"] == 0.0 and res.get("hit_share", 0.0)
                  == 0.0, f"all-dead rays: {res}")
        results.append(res)
        emit("kernel", **res)
    check(results[0]["set"] == "boxes, random" and
          results[0]["mode"] == "closest", "the main case comes first")
    return results, max(r["max_abs_err"] for r in results)


def phase_render():
    from tputracer_torch.accel import intersect_cuda as ic
    from tputracer_torch.accel import intersect_plain, occluded_plain
    from tputracer_torch.api import render
    from tputracer_torch.config import RenderConfig
    from tputracer_torch.integrators.pt import render_pt
    from tputracer_torch.scene import cornell_box

    scene = cornell_box("boxes", device="cuda")
    cfg = RenderConfig(width=512, height=512, spp=16, max_bounces=4)
    n_paths = cfg.width * cfg.height * cfg.spp
    n_chunks = -(-n_paths // cfg.chunk_size)
    want = n_chunks * (2 * cfg.max_bounces + 1)

    # the main path, counted: exactly this one call to render
    ic.LAUNCHES = 0
    img, stats = render(scene, cfg, device="cuda")
    torch.cuda.synchronize()
    launches = ic.LAUNCHES
    check(launches == want, f"render launched the kernel {launches} times, "
                            f"expected {want}")
    check(tuple(img.shape) == (cfg.height, cfg.width, 3),
          f"image shape {tuple(img.shape)}")
    check(bool(torch.isfinite(img).all()), "image has non-finite pixels")
    mean = float(img.mean())
    check(0.15 <= mean <= 0.30, f"image mean {mean} outside [0.15, 0.30]")
    issued = float(stats["rays_closest"].sum() + stats["rays_shadow"].sum())

    sc = scene.to("cuda")

    def kernel_run():
        render_pt(sc, cfg)

    def plain_run():
        render_pt(sc, cfg, intersect_fn=intersect_plain,
                  occluded_fn=occluded_plain)

    kernel_run()   # warm-up
    plain_run()
    kernel_s, plain_s = [], []
    for _ in range(3):   # in turns, so drift hits both alike
        kernel_s.append(cuda_ms(kernel_run, 0, 1) / 1e3)
        plain_s.append(cuda_ms(plain_run, 0, 1) / 1e3)
    render_s = statistics.median(kernel_s)
    plain_render_s = statistics.median(plain_s)
    flat = n_paths * (2 * cfg.max_bounces + 1)
    emit("render", config="boxes 512x512 16spp 4 bounces", launches=launches,
         mean=mean, render_s=render_s, render_s_all=kernel_s,
         flat_rays_per_s=flat / render_s,
         issued_rays=issued, issued_rays_per_s=issued / render_s,
         plain_render_s=plain_render_s, plain_render_s_all=plain_s,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return launches


def golden_compare(name, img, ref):
    """The golden tolerances of tests/golden/test_pt_vs_oracle.py."""
    err = np.abs(img - ref)
    rel = err / (1.0 + np.abs(ref))
    res = {"against": name, "mean_rel": float(rel.mean()),
           "outlier_share": float((rel > 5e-3).mean())}
    check(res["mean_rel"] < 5e-4, f"{name}: mean rel err {res['mean_rel']}")
    check(res["outlier_share"] < 0.01,
          f"{name}: outlier share {res['outlier_share']}")
    return res


def phase_parity():
    from tputracer_torch.accel import intersect_plain, occluded_plain
    from tputracer_torch.config import RenderConfig
    from tputracer_torch.integrators.pt import render_pt
    from tputracer_torch.scene import cornell_box

    cfg = RenderConfig(width=64, height=64, spp=4, max_bounces=4)
    scene = cornell_box("boxes", device="cpu")
    sc = scene.to("cuda")
    img_k = render_pt(sc, cfg)[0].cpu().numpy()
    img_p = render_pt(sc, cfg, intersect_fn=intersect_plain,
                      occluded_fn=occluded_plain)[0].cpu().numpy()
    img_c = render_pt(scene, cfg)[0].numpy()
    check(np.isfinite(img_k).all(), "64x64 render has non-finite pixels")
    emit("parity", config="boxes 64x64 4spp 4 bounces",
         results=[golden_compare("plain on card", img_k, img_p),
                  golden_compare("cpu render", img_k, img_c)],
         mean=float(img_k.mean()))


def room_rays(n, seed):
    """Rays from inside mesh_scene's room in random directions, like bounce
    rays; a quarter of the lanes dead; occlusion distances up to 3."""
    rng = np.random.default_rng(seed)
    o = rng.uniform((-1.9, 0.05, -1.9), (1.9, 2.9, 1.9), (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.zeros(n)
    tmax = np.full(n, BIG)
    tocc = rng.uniform(0.0, 3.0, n)
    tmax[::4] = 0.0
    tocc[::4] = 0.0
    return tuple(torch.from_numpy(x.astype(np.float32)).cuda()
                 for x in (o, d, tmin, tmax, tocc))


def mesh_camera_rays(scene, seed):
    """The first chunk of config 3's camera rays (coherent), with random
    occlusion distances up to 6."""
    from tputracer_torch.config import RenderConfig
    from tputracer_torch.integrators.pt import camera_rays

    uid = torch.arange(N_CHUNK, dtype=torch.int64, device="cuda")
    o, d = camera_rays(scene, uid, RenderConfig(**MESH_CFG))
    tocc = np.random.default_rng(seed).uniform(0.0, 6.0, N_CHUNK)
    return (o.contiguous(), d.contiguous(),
            torch.zeros(N_CHUNK, device="cuda"),
            torch.full((N_CHUNK,), BIG, device="cuda"),
            torch.from_numpy(tocc.astype(np.float32)).cuda())


def traverse_case(rays_name, any_hit, rays, args, leaf, timed=True):
    """Traversal kernel vs the plain walk on one ray set and mode, from
    bt0 = tmax, bp0 = -1."""
    o, d, tmin, tmax, tocc = rays
    if any_hit:
        tmax = tocc
    bp0 = torch.full((o.shape[0],), -1, dtype=torch.int32, device="cuda")
    return hold_walk(rays_name, any_hit, (o, d, tmin, tmax, tmax.clone(), bp0),
                     args, leaf, timed)


def hold_walk(rays_name, any_hit, walk_in, args, leaf, timed=True):
    """The traversal kernel against the plain walk on the walk's inputs
    (o, d, tmin, tmax, bt0, bp0): t and prim bit for bit.  With ``timed``,
    the kernel (cuda_ms and device_ms) and the plain walk timed."""
    from tputracer_torch.accel import clustered as cl
    from tputracer_torch.accel import traverse_cuda as tc

    o, d, tmin, tmax = walk_in[:4]
    n = o.shape[0]

    def kernel():
        return tc.traverse_cuda(*walk_in, *args, leaf=leaf, any_hit=any_hit)

    def plain():
        return cl._traverse(*walk_in, *args, leaf=leaf, any_hit=any_hit)

    t_p, p_p = plain()
    res = {"rays": rays_name, "n_rays": n,
           "mode": "any" if any_hit else "closest",
           "hit_share": float((p_p >= 0).float().mean())}
    t_k, p_k = kernel()
    torch.cuda.synchronize()
    mism = {"prim": int((p_k != p_p).sum()), "t": int((t_k != t_p).sum())}
    max_abs = float((t_k - t_p).abs().max()) if n else 0.0
    res.update(prim_mismatch=mism["prim"], t_mismatch=mism["t"],
               max_abs_err=max_abs)
    check(mism == {"prim": 0, "t": 0} and max_abs == 0.0,
          f"traverse {rays_name}: the kernel differs from the plain walk "
          f"{mism}, t err {max_abs}")
    if not any_hit:
        res["bound_ms"], res["bound_by"], res["clusters"] = walk_bound(
            o, d, tmin, tmax, t_p, args, leaf)
    if timed:
        res["ms"] = cuda_ms(kernel, 2, 5)
        res["device_ms"] = device_ms(kernel)
        res["plain_ms"] = cuda_ms(plain, 1, 3)
    return res


def walk_bound(o, d, tmin, tmax, t_final, args, leaf):
    """Least work of a closest-hit walk on this data: one slab scan of all
    C boxes per live ray, and a plane test of every valid slot of each
    cluster entered before the ray's final hit.  Returns (bound_ms,
    bound_by, counts): the clusters each live ray admits (least, mean,
    most) and enters before its final hit, which the walk visits (mean,
    most), and the share of live rays with two or more entries at te = 0."""
    from tputracer_torch.accel import clustered as cl

    cmin, cmax, plu, mask = args[0], args[1], args[2], args[5]
    C, T = cmin.shape[0], plu.shape[2]
    valid = (mask > 0).float().reshape(C, leaf).sum(1)
    live = tmax > tmin
    tests = 0.0
    adm, seen_n, zero = [], [], []
    for r0 in range(0, o.shape[0], 1 << 13):
        rs = slice(r0, r0 + (1 << 13))
        te = cl.cluster_entries(o[rs], d[rs], tmin[rs], tmax[rs], cmin, cmax)
        seen = (te < t_final[rs, None]) & live[rs, None]
        tests += float((seen.float() @ valid).sum())
        adm.append((te < BIG).sum(1)[live[rs]])
        seen_n.append(seen.sum(1)[live[rs]])
        zero.append((te == 0.0).sum(1)[live[rs]])
    ops = float(live.sum()) * C * OPS_SLAB + tests * OPS_PLANE
    nbytes = 4 * (12 * o.shape[0] + 6 * C + 23 * T)
    adm, seen_n = torch.cat(adm).float(), torch.cat(seen_n).float()
    counts = {"admitted_min": int(adm.min()), "admitted_mean":
              float(adm.mean()), "admitted_max": int(adm.max()),
              "visited_mean": float(seen_n.mean()),
              "visited_max": int(seen_n.max()), "zero_tie_share":
              float((torch.cat(zero) >= 2).float().mean())}
    return (*bound(ops, nbytes), counts)


def face_rays(cmin, cmax, n, seed, device="cuda"):
    """Rays from a point on a face of a random cluster's box into the box:
    on a max face the slab gives t = (cmax - o) * (1/d) = 0 * (negative),
    which is -0, on a min face +0, so entries tie at te = +-0 with every
    box that holds the origin.  tmax = 3e38; occlusion distances up to 3."""
    rng = np.random.default_rng(seed)
    lo, hi = cmin.cpu().numpy(), cmax.cpu().numpy()
    c = rng.integers(0, lo.shape[0], n)
    o = (lo[c] + rng.uniform(0.0, 1.0, (n, 3)) * (hi[c] - lo[c])).astype(
        np.float32)
    rows, axis = np.arange(n), rng.integers(0, 3, n)
    on_max = rng.integers(0, 2, n) == 1
    o[rows, axis] = np.where(on_max, hi[c, axis], lo[c, axis])
    d = rng.normal(size=(n, 3))
    d[rows, axis] = np.abs(d[rows, axis]) * np.where(on_max, -1.0, 1.0)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tocc = rng.uniform(0.0, 3.0, n)
    return tuple(torch.from_numpy(np.asarray(x, np.float32)).to(device)
                 for x in (o, d, np.zeros(n), np.full(n, BIG), tocc))


def soup_scene(n_tris, seed, device="cuda"):
    """A clustered soup of large random triangles (vertices anywhere in
    [-1, 1]^3) in 128-slot leaves, built by make_scene's BVH builder: every
    cluster box spans most of the cube."""
    from tputracer_torch.scene.types import DIFFUSE, make_scene

    tv = np.random.default_rng(seed).uniform(-1.0, 1.0, (n_tris, 3, 3))
    return make_scene(tv.astype(np.float32), np.zeros(n_tris, np.int32),
                      [{"kind": DIFFUSE, "albedo": (0.5, 0.5, 0.5)}],
                      accel="cluster", leaf_size=128, device=device)


def soup_rays(n, seed, device="cuda"):
    """Rays from a sphere of radius 3 aimed into [-0.5, 0.5]^3, through the
    soup; occlusion distances up to 6."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o *= 3.0 / np.linalg.norm(o, axis=1, keepdims=True)
    d = rng.uniform(-0.5, 0.5, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return tuple(torch.from_numpy(np.asarray(x, np.float32)).to(device)
                 for x in (o, d, np.zeros(n), np.full(n, BIG),
                           rng.uniform(0.0, 6.0, n)))


def fallback_input(sc, o, d, tmin, tmax):
    """The walk's inputs in the pair route's fallback call
    (accel.pairs._pair_traverse), closest hit from bt0 = tmax: the rays
    the K slots leave unresolved first, the resolved ones at tmax = 0,
    each starting from the slots' best.  Returns (inputs, unresolved)."""
    from tputracer_torch.accel import pairs

    bt0 = tmax.clone()
    bp0 = torch.full(tmax.shape, -1, dtype=torch.int32, device=o.device)
    best_t, best_p, resolved = pairs._slot_best(sc, o, d, tmin, tmax, bt0,
                                                bp0, False)
    _, fidx = torch.sort(resolved.to(torch.int32), stable=True)
    walk_in = (o[fidx], d[fidx], tmin[fidx],
               torch.where(resolved, 0.0, tmax)[fidx], best_t[fidx],
               best_p[fidx])
    return walk_in, int((~resolved & (tmax > tmin)).sum())


def phase_traverse(mesh):
    """The traversal kernel against its plain version at a config-3 chunk."""
    from tputracer_torch.accel import clustered as cl
    from tputracer_torch.accel import traverse_cuda as tc
    from tputracer_torch.accel import intersect_clustered, occluded_clustered
    from tputracer_torch.scene import cornell_box

    sc = mesh.to("cuda")
    args = cl.traverse_args(sc)
    leaf = sc.leaf_size
    results = []
    for name, rays in (("camera", mesh_camera_rays(sc, seed=5)),
                       ("random", room_rays(N_CHUNK, seed=6))):
        for any_hit in (False, True):
            res = traverse_case(name, any_hit, rays, args, leaf)
            results.append(res)
            emit("traverse", **res)

    # rays on cluster box faces: entries tie at te = +-0
    rays = face_rays(args[0], args[1], N_CHUNK, seed=10)
    for any_hit in (False, True):
        res = traverse_case("faces", any_hit, rays, args, leaf)
        results.append(res)
        emit("traverse", **res)
        if not any_hit:
            tie = res["clusters"]["zero_tie_share"]
            check(tie > 0.5, f"face rays: only {tie} tie at te = 0")

    # the pair route's fallback call (as chip_profile.py builds it)
    o, d, tmin, tmax, _ = room_rays(N_CHUNK, seed=6)
    walk_in, unresolved = fallback_input(sc, o, d, tmin, tmax)
    res = hold_walk("pair fallback", False, walk_in, args, leaf)
    res["unresolved_rays"] = unresolved
    results.append(res)
    emit("traverse", **res)

    # deep walks: every ray admits more than 4 x 32 clusters (the mesh's
    # rays admit a few, see "clusters" above), more than the 32 lanes'
    # 4-entry buffers hold, so lanes refill them
    soup = soup_scene(102_410, seed=11)
    sargs = cl.traverse_args(soup)
    rays = soup_rays(1 << 12, seed=12)
    for any_hit in (False, True):
        res = traverse_case("deep", any_hit, rays, sargs, soup.leaf_size)
        res["n_clusters"] = soup.n_clusters
        results.append(res)
        emit("traverse", **res)
        if not any_hit:
            least = res["clusters"]["admitted_min"]
            check(least > 4 * 32,
                  f"soup rays admit as few as {least} clusters")

    # a ragged count: the last block is partly out of range
    small = tuple(x[:1000] for x in room_rays(N_CHUNK, seed=7))
    results.append(traverse_case("ragged", False, small, args, leaf,
                                 timed=False))
    # spheres (the preamble) and 16-slot leaves, through the Hit wrappers
    sph = cornell_box("spheres", accel="cluster", leaf_size=16,
                      device="cuda")
    o, d, tmin, tmax, tocc = random_rays(N_CHUNK, seed=8)
    hk = tc.intersect_traverse(sph, o, d, tmin, tmax)
    hp = intersect_clustered(sph, o, d, tmin, tmax)
    occ_mism = int((tc.occluded_traverse(sph, o, d, tocc)
                    != occluded_clustered(sph, o, d, tocc)).sum())
    mism = int((hk.prim != hp.prim).sum())
    t_mism = int((hk.t != hp.t).sum())
    max_abs = float((hk.t - hp.t).abs().max())
    sph_share = float((hp.prim >= sph.n_tri_pad).float().mean())
    emit("traverse", rays="spheres leaf 16", n_rays=N_CHUNK,
         prim_mismatch=mism, t_mismatch=t_mism, occluded_mismatch=occ_mism,
         max_abs_err=max_abs, sphere_hit_share=sph_share,
         n_clusters=sph.n_clusters)
    check(mism == 0 and t_mism == 0 and occ_mism == 0 and max_abs == 0.0,
          f"spheres scene: {mism} prims, {t_mism} t, {occ_mism} booleans, "
          f"t err {max_abs}")
    check(sph_share > 0.05, f"spheres scene: sphere hit share {sph_share}")
    return results, max(r["max_abs_err"] for r in results)


def phase_mesh_render(mesh):
    """The config-3 path: api.render of the 102,410-triangle mesh."""
    from tputracer_torch.accel import intersect_clustered, occluded_clustered
    from tputracer_torch.accel import intersect_cuda as ic
    from tputracer_torch.accel import traverse_cuda as tc
    from tputracer_torch.api import render
    from tputracer_torch.config import RenderConfig
    from tputracer_torch.integrators.pt import render_pt

    cfg = RenderConfig(**MESH_CFG)
    n_paths = cfg.width * cfg.height * cfg.spp
    n_chunks = -(-n_paths // cfg.chunk_size)
    want = n_chunks * (2 * cfg.max_bounces + 1)

    # the config-3 path, counted: exactly this one call to render
    torch.cuda.reset_peak_memory_stats()
    tc.LAUNCHES = 0
    ic.LAUNCHES = 0
    img, stats = render(mesh, cfg, device="cuda")
    torch.cuda.synchronize()
    launches, fused = tc.LAUNCHES, ic.LAUNCHES
    check(launches == want, f"mesh render launched the traversal kernel "
                            f"{launches} times, expected {want}")
    check(fused == 0, f"mesh render launched the intersection kernel "
                      f"{fused} times")
    check(tuple(img.shape) == (cfg.height, cfg.width, 3),
          f"image shape {tuple(img.shape)}")
    check(bool(torch.isfinite(img).all()), "mesh image has non-finite pixels")
    mean = float(img.mean())
    check(0.20 <= mean <= 0.30, f"mesh image mean {mean} outside [0.20, 0.30]")
    issued = float(stats["rays_closest"].sum() + stats["rays_shadow"].sum())

    sc = mesh.to("cuda")
    kernel_s = []
    render_pt(sc, cfg)   # warm-up
    for _ in range(3):
        kernel_s.append(cuda_ms(lambda: render_pt(sc, cfg), 0, 1) / 1e3)
    render_s = statistics.median(kernel_s)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the plain walk in the kernel's place: one run, not a median
    plain_s = cuda_ms(lambda: render_pt(
        sc, cfg, intersect_fn=intersect_clustered,
        occluded_fn=occluded_clustered), 0, 1) / 1e3
    flat = n_paths * (2 * cfg.max_bounces + 1)
    emit("mesh_render", config="mesh subdiv=6 256x256 4spp 8 bounces rr 3",
         launches=launches, fused_launches=fused, mean=mean,
         render_s=render_s, render_s_all=kernel_s,
         flat_rays_per_s=flat / render_s, issued_rays=issued,
         issued_rays_per_s=issued / render_s,
         plain_render_s_once=plain_s, peak_mem_gb=peak_gb)
    return launches, img.cpu().numpy()


def phase_mesh_parity():
    from tputracer_torch.accel import intersect_clustered, occluded_clustered
    from tputracer_torch.config import RenderConfig
    from tputracer_torch.integrators.pt import render_pt
    from tputracer_torch.scene import mesh_scene

    cfg = RenderConfig(width=32, height=32, spp=4, max_bounces=8, rr_start=3)
    scene = mesh_scene(subdiv=4, device="cpu")
    sc = scene.to("cuda")
    img_k = render_pt(sc, cfg)[0].cpu().numpy()
    img_p = render_pt(sc, cfg, intersect_fn=intersect_clustered,
                      occluded_fn=occluded_clustered)[0].cpu().numpy()
    img_c = render_pt(scene, cfg)[0].numpy()
    check(np.isfinite(img_k).all(), "32x32 mesh render has non-finite pixels")
    emit("mesh_parity", config="mesh subdiv=4 32x32 4spp 8 bounces rr 3",
         results=[golden_compare("plain on card", img_k, img_p),
                  golden_compare("cpu render", img_k, img_c)],
         bitwise_equal_plain=bool((img_k == img_p).all()),
         mean=float(img_k.mean()))


def skew_bound(sc, o, d, prim, t):
    """How far the plane test and Moeller-Trumbore may place the same hit
    apart: 1e-6 |t| plus four times the two formulas' rounding bounds
    (accel.pairs.rounding_bounds).  Sphere hits come from one preamble in
    both routes: 1e-6 |t|."""
    from tputracer_torch.accel.pairs import rounding_bounds

    tri = (prim >= 0) & (prim < sc.n_tri_pad)
    plane, mt = rounding_bounds(sc, o, d, prim.clamp(0, sc.n_tri_pad - 1), t)
    rel = 1e-6 * t.double().abs()
    return torch.where(tri, rel + 4.0 * (plane + mt), rel).float()


def pairs_case(name, sc, rays, any_hit, timed):
    """The expand and pair-test kernels against their plain versions on one
    ray set and mode, bit for bit, and the whole pair route against the
    traversal kernel; with ``timed``, each timed beside its bound."""
    from tputracer_torch.accel import clustered as cl
    from tputracer_torch.accel import pairs
    from tputracer_torch.accel import pairs_cuda as pc
    from tputracer_torch.accel import traverse_cuda as tc

    o, d, tmin, tmax, tocc = rays
    if any_hit:
        tmin, tmax = torch.zeros_like(tocc), tocc
    n, k, leaf, C = o.shape[0], pairs.K, sc.leaf_size, sc.n_clusters
    cmin, cmax, v0, e1, e2, mask = pairs.pairs_args(sc)
    bt0, bp0 = cl._sphere_best(sc, o, d, tmin, tmax)
    bt0 = torch.minimum(bt0, tmax)

    def expand_k():
        return pc.expand_cuda(o, d, tmin, tmax, cmin, cmax, k=k)

    def expand_p():
        return pairs.expand_plain(o, d, tmin, tmax, cmin, cmax, k=k)

    cid, te, bnd = expand_k()
    cid_p, te_p, bnd_p = expand_p()
    torch.cuda.synchronize()
    res = {"rays": name, "n_rays": n, "mode": "any" if any_hit else "closest",
           "scene": f"{sc.n_tris} tris, {C} clusters of {leaf}",
           "expand_mismatch": {
               "cid": int((cid != cid_p).sum()), "te": int((te != te_p).sum()),
               "bound": int((bnd != bnd_p).sum())}}
    check(sum(res["expand_mismatch"].values()) == 0,
          f"pairs {name}: expand differs from its plain version "
          f"{res['expand_mismatch']}")
    res["expand_max_abs_err"] = max(
        float((te - te_p).abs().max()), float((bnd - bnd_p).abs().max()))

    # the pairs as the route's glue builds them
    flat = cid.reshape(n * k)
    _, sidx = torch.sort(torch.where(flat >= 0, flat, C + 1), stable=True)
    ray = sidx // k
    pargs = (o[ray], d[ray], tmin[ray], flat[sidx],
             te.reshape(n * k)[sidx], bt0[ray], v0, e1, e2, mask)

    def test_k():
        return pc.pairtest_cuda(*pargs, leaf=leaf)

    def test_p():
        return pairs.pairtest_plain(*pargs, leaf=leaf)

    t_k, p_k = test_k()
    t_p, p_p = test_p()
    torch.cuda.synchronize()
    res["pairtest_mismatch"] = {"t": int((t_k != t_p).sum()),
                                "p": int((p_k != p_p).sum())}
    check(sum(res["pairtest_mismatch"].values()) == 0,
          f"pairs {name}: pair test differs from its plain version "
          f"{res['pairtest_mismatch']}")
    hit = p_p >= 0
    res["pairtest_max_abs_err"] = (float((t_k - t_p).abs()[hit].max())
                                   if bool(hit.any()) else 0.0)
    wanted = (pargs[4] < pargs[5]) & (pargs[3] >= 0)
    res["pairs"] = n * k
    res["wanted_pairs"] = int(wanted.sum())

    # the whole route against the traversal kernel
    def route():
        return pairs._pair_traverse(sc, o, d, tmin, tmax, bt0, bp0, any_hit)

    targs = cl.traverse_args(sc)

    def walk():
        return tc.traverse_cuda(o, d, tmin, tmax, bt0, bp0, *targs,
                                leaf=leaf, any_hit=any_hit)

    t_r, p_r = route()
    t_w, p_w = walk()
    _, _, resolved = pairs._slot_best(sc, o, d, tmin, tmax, bt0, bp0,
                                      any_hit)
    torch.cuda.synchronize()
    live = tmax > tmin
    res["resolved_share"] = float(resolved[live].float().mean())
    if any_hit:
        occ = int(((t_r < tmax) != (t_w < tmax)).sum())
        res["route_occluded_mismatch"] = occ
        check(occ == 0, f"pairs {name}: {occ} occlusion booleans differ "
                        f"from the traversal kernel")
    else:
        # slot hits are Moeller-Trumbore, the walk's the plane test: t agree
        # to within both formulas' rounding, and a prim may differ only
        # where the two hits tie to within that
        hit = p_w >= 0
        ratio = ((t_r - t_w).abs() / skew_bound(sc, o, d, p_w, t_w))[hit]
        close = torch.zeros_like(hit)
        close[hit] = ratio <= 1.0
        res["route_prim_mismatch"] = int((p_r != p_w).sum())
        res["route_t_beyond_tol"] = int((hit & ~close).sum())
        res["route_t_err_over_bound"] = float(ratio.max())
        check(res["route_t_beyond_tol"] == 0 and res["route_prim_mismatch"]
              == int(((p_r != p_w) & close).sum()) and
              res["route_prim_mismatch"] <= 1e-4 * n,
              f"pairs {name}: the route differs from the traversal kernel "
              f"beyond ties {res}")
    res["hit_share"] = float((p_w >= 0).float().mean())
    if not timed:
        return res

    valid = (mask > 0).float().reshape(C, leaf).sum(1)
    slots = float(valid[pargs[3][wanted].long()].sum())
    res["expand_bound_ms"], res["expand_bound_by"] = bound(
        float(live.sum()) * C * OPS_SLAB,
        4 * (n * (8 + 2 * k + 1) + 6 * C))
    res["pairtest_bound_ms"], res["pairtest_bound_by"] = bound(
        slots * OPS_MT, 4 * (n * k * 12 + 10 * mask.shape[0]))
    for key, fn in (("expand", expand_k), ("pairtest", test_k),
                    ("route", route), ("traverse", walk)):
        res[f"{key}_ms"] = cuda_ms(fn, 2, 5)
        res[f"{key}_device_ms"] = device_ms(fn)
    res["expand_plain_ms"] = cuda_ms(expand_p, 1, 3)
    res["pairtest_plain_ms"] = cuda_ms(test_p, 1, 3)
    if not any_hit:
        res["traverse_bound_ms"], res["traverse_bound_by"], _ = walk_bound(
            o, d, tmin, tmax, t_w, targs, leaf)
    return res


def phase_pairs(mesh):
    """The pair route's two kernels against their plain versions, and the
    route against the traversal kernel, at config-3 chunk sizes."""
    from tputracer_torch.scene import cornell_box

    results = []
    sets = [("camera", mesh_camera_rays(mesh, seed=5)),
            ("random", room_rays(N_CHUNK, seed=6)),
            ("random 2^18", room_rays(4 * N_CHUNK, seed=9))]
    for name, rays in sets:
        for any_hit in (False, True):
            res = pairs_case(name, mesh, rays, any_hit, timed=True)
            results.append(res)
            emit("pairs", **res)
    # a ragged count: the last block is partly out of range
    small = tuple(x[:1000] for x in room_rays(N_CHUNK, seed=7))
    emit("pairs", **pairs_case("ragged", mesh, small, False, timed=False))
    # spheres (bt0 from the preamble) and 16-slot leaves
    sph = cornell_box("spheres", accel="cluster", leaf_size=16,
                      device="cuda")
    for any_hit in (False, True):
        emit("pairs", **pairs_case("spheres leaf 16", sph,
                                   random_rays(N_CHUNK, seed=8), any_hit,
                                   timed=False))
    return results


def phase_pairs_render(mesh, default_img):
    """The config-3 render through the pair route (TPUTRACER_PAIRS=1, set
    for this phase only), counted, checked and timed in turns with the
    default route."""
    from tputracer_torch.accel import intersect_cuda as ic
    from tputracer_torch.accel import pairs_cuda as pc
    from tputracer_torch.accel import traverse_cuda as tc
    from tputracer_torch.api import render
    from tputracer_torch.config import RenderConfig
    from tputracer_torch.integrators.pt import render_pt

    cfg = RenderConfig(**MESH_CFG)
    n_chunks = -(-cfg.width * cfg.height * cfg.spp // cfg.chunk_size)
    want = n_chunks * (2 * cfg.max_bounces + 1)
    before = os.environ.get("TPUTRACER_PAIRS")

    def set_pairs(on):
        if on:
            os.environ["TPUTRACER_PAIRS"] = "1"
        else:
            os.environ.pop("TPUTRACER_PAIRS", None)

    try:
        set_pairs(True)
        # the pair route, counted: exactly this one call to render
        pc.EXPAND_LAUNCHES = pc.PAIRTEST_LAUNCHES = 0
        tc.LAUNCHES = ic.LAUNCHES = 0
        img, stats = render(mesh, cfg, device="cuda")
        torch.cuda.synchronize()
        launches = {"expand": pc.EXPAND_LAUNCHES,
                    "pair_test": pc.PAIRTEST_LAUNCHES,
                    "traverse": tc.LAUNCHES, "fused_intersect": ic.LAUNCHES}
        check(launches == {"expand": want, "pair_test": want,
                           "traverse": want, "fused_intersect": 0},
              f"pairs render launched {launches}, expected {want} of each "
              f"route kernel and no intersection kernel")
        check(bool(torch.isfinite(img).all()),
              "pairs render has non-finite pixels")
        img = img.cpu().numpy()
        mean = float(img.mean())
        check(0.20 <= mean <= 0.30,
              f"pairs render mean {mean} outside [0.20, 0.30]")
        parity = golden_compare("default route", img, default_img)

        def run(on):
            set_pairs(on)
            return cuda_ms(lambda: render_pt(mesh, cfg), 0, 1) / 1e3

        run(True)   # warm-up of both routes
        run(False)
        pairs_s, default_s = [], []
        for _ in range(3):   # in turns, so drift hits both alike
            pairs_s.append(run(True))
            default_s.append(run(False))
    finally:
        if before is None:
            os.environ.pop("TPUTRACER_PAIRS", None)
        else:
            os.environ["TPUTRACER_PAIRS"] = before
    emit("pairs_render", config="mesh subdiv=6 256x256 4spp 8 bounces rr 3",
         launches=launches, mean=mean, parity=parity,
         render_s=statistics.median(pairs_s), render_s_all=pairs_s,
         default_render_s=statistics.median(default_s),
         default_render_s_all=default_s,
         issued_rays=float(stats["rays_closest"].sum()
                           + stats["rays_shadow"].sum()))
    return launches


def main():
    phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 stays float32
    torch.backends.cudnn.allow_tf32 = False
    mesh = phase_build()
    results, max_abs = phase_kernel()
    launches = phase_render()
    phase_parity()
    t_results, t_max_abs = phase_traverse(mesh)
    t_launches, mesh_img = phase_mesh_render(mesh)
    phase_mesh_parity()
    p_results = phase_pairs(mesh)
    p_launches = phase_pairs_render(mesh, mesh_img)
    main_case = results[0]   # boxes, closest hit: the main path's shape
    # random rays, closest hit: the shape of most of a render's calls
    t_case = next(r for r in t_results
                  if r["rays"] == "random" and r["mode"] == "closest")
    p_case = next(r for r in p_results
                  if r["rays"] == "random" and r["mode"] == "closest")
    p_case_18 = next(r for r in p_results
                     if r["rays"] == "random 2^18" and r["mode"] == "closest")
    print(json.dumps({"kernels": [{
        "name": "fused_intersect",
        "route": "cuda",
        "source": "tputracer_torch/csrc/intersect.cu",
        "replaces": "tputracer/accel/intersect_tpu.py:44",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": main_case["ms"],
        "device_ms": main_case["device_ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": None,
    }, {
        "name": "traverse",
        "route": "cuda",
        "source": "tputracer_torch/csrc/traverse.cu",
        "replaces": "tputracer/accel/traverse_tpu.py:173",
        "launches": t_launches,
        "max_abs_err": t_max_abs,
        "ms": t_case["ms"],
        "device_ms": t_case["device_ms"],
        "plain_ms": t_case["plain_ms"],
        "bound_ms": t_case["bound_ms"],
        "bound_by": t_case["bound_by"],
        "library_ms": None,
        "ms_2p18": p_case_18["traverse_ms"],
    }, {
        "name": "pair_expand",
        "route": "cuda",
        "source": "tputracer_torch/csrc/pairs.cu",
        "replaces": "tputracer/accel/pairs_tpu.py:66",
        "launches": p_launches["expand"],
        "max_abs_err": max(r["expand_max_abs_err"] for r in p_results),
        "ms": p_case["expand_ms"],
        "device_ms": p_case["expand_device_ms"],
        "plain_ms": p_case["expand_plain_ms"],
        "bound_ms": p_case["expand_bound_ms"],
        "bound_by": p_case["expand_bound_by"],
        "library_ms": None,
    }, {
        "name": "pair_test",
        "route": "cuda",
        "source": "tputracer_torch/csrc/pairs.cu",
        "replaces": "tputracer/accel/pairs_tpu.py:139",
        "launches": p_launches["pair_test"],
        "max_abs_err": max(r["pairtest_max_abs_err"] for r in p_results),
        "ms": p_case["pairtest_ms"],
        "device_ms": p_case["pairtest_device_ms"],
        "plain_ms": p_case["pairtest_plain_ms"],
        "bound_ms": p_case["pairtest_bound_ms"],
        "bound_by": p_case["pairtest_bound_by"],
        "library_ms": None,
    }]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
