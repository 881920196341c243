#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tputracer_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each printing one line:

  1. device: needs torch.cuda; prints the card's name and power limit.
  2. build: compiles both kernels from tputracer_torch/csrc/ (one nvcc per
     source, started together) and builds the config-3 mesh scene, saying
     which BVH builder (native or NumPy) ran.
  3. kernel: the intersection kernel against its plain PyTorch version on
     2^20 random rays (Cornell boxes and spheres, closest and any hit, a
     quarter of the lanes dead), and both timed.
  4. render: the config-1 path, tputracer_torch.api.render of Cornell boxes
     at 512x512, 16 spp, 4 bounces; it must launch the intersection kernel
     36 times (4 chunks x (5 closest + 4 shadow)) and give a sane image.
     Timed with the kernel and with the plain version in its place.
  5. parity: a 64x64, 4 spp render with the kernel against the same render
     with the plain version on the card, and against the CPU render.
  6. traverse: the traversal kernel against its plain version (the
     clustered walk) on the 102,410-triangle mesh at 2^16 rays (one
     config-3 chunk): camera rays and random rays from inside the room,
     closest and any hit; a ragged count; a scene with spheres and 16-slot
     leaves.  Both timed.
  7. mesh render: the config-3 path, api.render of mesh_scene(subdiv=6) at
     256x256, 4 spp, 8 bounces; it must launch the traversal kernel 68
     times (4 chunks x (9 closest + 8 shadow)), the intersection kernel
     never, and give a sane image.  Timed with the kernel, and once with
     the plain walk in its place.
  8. mesh parity: mesh_scene(subdiv=4) at 32x32, 4 spp, 8 bounces with the
     kernel, with the plain walk on the card, and on the CPU.

Then a JSON line of per-kernel results, the card's name and power limit,
and last {"ok": true, "device": {...}}.  Any failure raises and the script
exits non-zero without that last line; there is no CPU fallback.
"""

from __future__ import annotations

import json
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
    from tputracer_torch.accel import traverse_cuda as tc
    from tputracer_torch.scene import mesh_scene

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:     # one nvcc per source, together
        for job in [pool.submit(ic.load_kernel), pool.submit(tc.load_kernel)]:
            job.result()
    nvcc_s = time.perf_counter() - t0
    ptxas = {src: [ln.strip() for ln in
                   cuda_build.BUILD_LOG.get(src, "").splitlines()
                   if "registers" in ln or "spill" in ln]
             for src in ("intersect.cu", "traverse.cu")}
    t0 = time.perf_counter()
    mesh = mesh_scene(subdiv=6)
    emit("build", seconds=round(nvcc_s, 3),
         nvcc_seconds={k: cuda_build.BUILD_SECONDS.get(k)
                       for k in ("intersect.cu", "traverse.cu")},
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


def compare_case(variant, any_hit, rays, args):
    """Kernel vs plain on one scene and mode; returns a result dict."""
    from tputracer_torch.accel import intersect_cuda as ic

    o, d, tmin, tmax, tocc = rays
    if any_hit:
        tmin, tmax = torch.zeros_like(tocc), tocc
    t_k, p_k = ic.fused_intersect_cuda(o, d, tmin, tmax, *args,
                                       any_hit=any_hit)
    t_p, p_p = ic.fused_intersect_plain(o, d, tmin, tmax, *args)
    torch.cuda.synchronize()
    n = o.shape[0]
    res = {"scene": variant, "mode": "any" if any_hit else "closest"}
    if any_hit:
        occ_k, occ_p = t_k < tmax, t_p < tmax
        mism = int((occ_k != occ_p).sum())
        res.update(occluded_mismatch=mism, occluded_share=float(
            occ_p.float().mean()))
        check(mism <= 1e-4 * n, f"{variant} any-hit: {mism} booleans differ")
        max_abs = 0.0
    else:
        agree = p_k == p_p
        mism = int((~agree).sum())
        both = agree & (p_k >= 0)
        err = (t_k - t_p).abs()[both]
        rel = (err / t_p.abs()[both].clamp(min=1e-30))
        max_abs = float(err.max()) if err.numel() else 0.0
        bad_t = int((rel > 1e-5).sum())
        res.update(prim_mismatch=mism, t_mismatch=bad_t, max_abs_err=max_abs,
                   hit_share=float((p_p >= 0).float().mean()))
        check(mism <= 1e-4 * n, f"{variant} closest: {mism} prims differ")
        check(bad_t == 0, f"{variant} closest: {bad_t} t beyond rtol 1e-5")
    res["ms"] = cuda_ms(lambda: ic.fused_intersect_cuda(
        o, d, tmin, tmax, *args, any_hit=any_hit), 2, 5)
    res["plain_ms"] = cuda_ms(lambda: ic.fused_intersect_plain(
        o, d, tmin, tmax, *args), 2, 5)
    return res, max_abs


def phase_kernel():
    from tputracer_torch.accel import intersect_cuda as ic
    from tputracer_torch.scene import cornell_box

    rays = random_rays(N_RAYS, seed=1234)
    results, max_abs = [], 0.0
    for variant in ("boxes", "spheres"):
        args = ic.scene_args(cornell_box(variant, device="cuda"))
        for any_hit in (False, True):
            res, err = compare_case(variant, any_hit, rays, args)
            max_abs = max(max_abs, err)
            results.append(res)
            emit("kernel", n_rays=N_RAYS, **res)
        # a ragged count: the last block is partly out of range
        small = tuple(x[:1000] for x in rays)
        res, err = compare_case(variant, False, small, args)
        max_abs = max(max_abs, err)
    return results, max_abs


def phase_render():
    from tputracer_torch.accel import intersect_cuda as ic
    from tputracer_torch.accel import intersect_plain, occluded_plain
    from tputracer_torch.api import render
    from tputracer_torch.config import RenderConfig
    from tputracer_torch.integrators.pt import render_pt
    from tputracer_torch.scene import cornell_box

    scene = cornell_box("boxes")
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
    scene = cornell_box("boxes")
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
    """Traversal kernel vs the plain walk on one ray set and mode."""
    from tputracer_torch.accel import clustered as cl
    from tputracer_torch.accel import traverse_cuda as tc

    o, d, tmin, tmax, tocc = rays
    if any_hit:
        tmax = tocc
    n = o.shape[0]
    bt0 = tmax.clone()
    bp0 = torch.full((n,), -1, dtype=torch.int32, device="cuda")

    def kernel():
        return tc.traverse_cuda(o, d, tmin, tmax, bt0, bp0, *args, leaf=leaf,
                                any_hit=any_hit)

    def plain():
        return cl._traverse(o, d, tmin, tmax, bt0, bp0, *args, leaf=leaf,
                            any_hit=any_hit)

    t_k, p_k = kernel()
    t_p, p_p = plain()
    torch.cuda.synchronize()
    mism = int((p_k != p_p).sum())
    both = p_k == p_p
    max_abs = float((t_k - t_p).abs()[both].max()) if n else 0.0
    res = {"rays": rays_name, "n_rays": n,
           "mode": "any" if any_hit else "closest",
           "prim_mismatch": mism, "max_abs_err": max_abs,
           "hit_share": float((p_p >= 0).float().mean())}
    check(mism <= 1e-4 * n, f"traverse {rays_name}: {mism} prims differ")
    check(max_abs == 0.0, f"traverse {rays_name}: t differs by {max_abs}")
    if any_hit:
        occ_mism = int(((t_k < tmax) != (t_p < tmax)).sum())
        res["occluded_mismatch"] = occ_mism
        check(occ_mism == 0, f"traverse {rays_name}: {occ_mism} occlusion "
                             f"booleans differ")
    if timed:
        res["ms"] = cuda_ms(kernel, 2, 5)
        res["plain_ms"] = cuda_ms(plain, 1, 3)
    return res


def phase_traverse(mesh):
    """The traversal kernel against its plain version at a config-3 chunk."""
    from tputracer_torch.accel import clustered as cl
    from tputracer_torch.accel import traverse_cuda as tc
    from tputracer_torch.accel import intersect_clustered, occluded_clustered
    from tputracer_torch.scene import cornell_box

    sc = mesh.to("cuda")
    args = cl.traverse_args(sc)
    results = []
    for name, rays in (("camera", mesh_camera_rays(sc, seed=5)),
                       ("random", room_rays(N_CHUNK, seed=6))):
        for any_hit in (False, True):
            res = traverse_case(name, any_hit, rays, args, sc.leaf_size)
            results.append(res)
            emit("traverse", **res)
    # a ragged count: the last block is partly out of range
    small = tuple(x[:1000] for x in room_rays(N_CHUNK, seed=7))
    results.append(traverse_case("ragged", False, small, args, sc.leaf_size,
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
    both = hk.prim == hp.prim
    max_abs = float((hk.t - hp.t).abs()[both].max())
    sph_share = float((hp.prim >= sph.n_tri_pad).float().mean())
    emit("traverse", rays="spheres leaf 16", n_rays=N_CHUNK,
         prim_mismatch=mism, occluded_mismatch=occ_mism,
         max_abs_err=max_abs, sphere_hit_share=sph_share,
         n_clusters=sph.n_clusters)
    check(mism <= 1e-4 * N_CHUNK and occ_mism == 0 and max_abs == 0.0,
          f"spheres scene: {mism} prims, {occ_mism} booleans, t err "
          f"{max_abs}")
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
    return launches


def phase_mesh_parity():
    from tputracer_torch.accel import intersect_clustered, occluded_clustered
    from tputracer_torch.config import RenderConfig
    from tputracer_torch.integrators.pt import render_pt
    from tputracer_torch.scene import mesh_scene

    cfg = RenderConfig(width=32, height=32, spp=4, max_bounces=8, rr_start=3)
    scene = mesh_scene(subdiv=4)
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


def main():
    phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 stays float32
    torch.backends.cudnn.allow_tf32 = False
    mesh = phase_build()
    results, max_abs = phase_kernel()
    launches = phase_render()
    phase_parity()
    t_results, t_max_abs = phase_traverse(mesh)
    t_launches = phase_mesh_render(mesh)
    phase_mesh_parity()
    main_case = results[0]   # boxes, closest hit: the main path's shape
    # random rays, closest hit: the shape of most of a render's calls
    t_case = next(r for r in t_results
                  if r["rays"] == "random" and r["mode"] == "closest")
    print(json.dumps({"kernels": [{
        "name": "fused_intersect",
        "route": "cuda",
        "source": "tputracer_torch/csrc/intersect.cu",
        "replaces": "tputracer/accel/intersect_tpu.py:44",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
    }, {
        "name": "traverse",
        "route": "cuda",
        "source": "tputracer_torch/csrc/traverse.cu",
        "replaces": "tputracer/accel/traverse_tpu.py:173",
        "launches": t_launches,
        "max_abs_err": t_max_abs,
        "ms": t_case["ms"],
        "plain_ms": t_case["plain_ms"],
    }]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
