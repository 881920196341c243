#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tputracer_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each printing one line:

  1. device: needs torch.cuda; prints the card's name and power limit.
  2. build: compiles the intersection kernel from tputracer_torch/csrc/.
  3. kernel: the CUDA kernel against its plain PyTorch version on 2^20
     random rays (Cornell boxes and spheres, closest and any hit, a quarter
     of the lanes dead), and both timed.
  4. render: the main path, tputracer_torch.api.render of Cornell boxes
     at 512x512, 16 spp, 4 bounces; it must launch the kernel 36 times
     (4 chunks x (5 closest + 4 shadow)) and give a sane image.  Timed with
     the kernel and with the plain version in its place.
  5. parity: a 64x64, 4 spp render with the kernel against the same render
     with the plain version on the card, and against the CPU render.

Then a JSON line of per-kernel results, the card's name and power limit,
and last {"ok": true, "device": {...}}.  Any failure raises and the script
exits non-zero without that last line; there is no CPU fallback.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

N_RAYS = 1 << 20
BIG = 3.0e38


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
    from tputracer_torch.accel import intersect_cuda as ic

    t0 = time.perf_counter()
    ic.load_kernel()
    ptxas = [ln.strip() for ln in
             cuda_build.BUILD_LOG.get("intersect.cu", "").splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         nvcc_seconds=cuda_build.BUILD_SECONDS.get("intersect.cu"),
         ptxas=ptxas)


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


def main():
    phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 stays float32
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    results, max_abs = phase_kernel()
    launches = phase_render()
    phase_parity()
    main_case = results[0]   # boxes, closest hit: the main path's shape
    print(json.dumps({"kernels": [{
        "name": "fused_intersect",
        "route": "cuda",
        "source": "tputracer_torch/csrc/intersect.cu",
        "replaces": "tputracer/accel/intersect_tpu.py:44",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
    }]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
