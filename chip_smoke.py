#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tputracer_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each printing one line:

  1. device: needs torch.cuda; prints the card's name and power limit.
  2. build: compiles the seven sources of tputracer_torch/csrc/ (one nvcc
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
     Timed with the kernel, and with the plain version's hooks, which send
     the render down the torch route (plain intersector and torch
     shading): a whole route against the kernels' route.
  5. parity: a 64x64, 4 spp render with the kernel against the same render
     with the plain version on the card, and against the CPU render.
  6. traverse: the traversal kernel against its plain version (the
     clustered walk), bit for bit (t and prim), on the 102,410-triangle
     mesh at 2^16 rays (one config-3 chunk): camera rays and random rays
     from inside the room, closest and any hit; rays that start on cluster
     box faces, so entries tie at te = +-0; the pair route's fallback input
     (the rays its slots resolve at tmax = 0); deep walks through
     a soup of large triangles at config 3's widths, where every ray admits
     more than 4 x 32 clusters, so the lanes refill their buffers; a
     ragged count; a scene with spheres and 16-slot leaves.  Timed beside
     the plain version and the bound; the clusters each ray admits and
     enters.
  7. mesh render: the config-3 path, api.render of mesh_scene(subdiv=6) at
     256x256, 4 spp, 8 bounces; it must launch the traversal kernel 68
     times (4 chunks x (9 closest + 8 shadow)), the intersection kernel
     never, and give a sane image.  Timed with the kernel, and once
     through the plain walk's hooks: the torch route, the plain walk and
     the torch shading.
  8. mesh parity: mesh_scene(subdiv=4) at 32x32, 4 spp, 8 bounces with the
     kernels, through the plain walk's hooks on the card (the torch route;
     bit for bit), and on the CPU.
  9. pairs: the expand and pair-test kernels (the pair route) against their
     plain versions, bit for bit, on the 102,410-triangle mesh at 2^16
     camera rays and at 2^16 and 2^18 random rays, closest and any hit; a
     ragged count; Cornell "spheres" in 16-slot clusters; rays whose pairs
     sort into long runs of one cluster beside runs of a single pair; a
     constructed tie between two slots of a ray (tie_pairs).  The whole
     route against the traversal kernel: prims equal except at ties,
     occlusion equal.  Timed at 2^16 and 2^18 rays: expand, pair test (its
     fold included), the route and the traversal kernel, each beside its
     bound (the pair test's from the Moeller-Trumbore stages the slots
     reach, the walk's from the edge signs); the share of live rays the K
     slots resolve.
 10. pairs render: the config-3 render of phase 7 with TPUTRACER_PAIRS=1
     (set for this phase only); it must launch the expand, pair-test and
     traversal kernels 68 times each, the intersection kernel never, give
     a mean in [0.20, 0.30] and match the default route's image at the
     golden tolerances.  Timed in turns with the default route.
 11. bdpt kernel: the rays trace_bdpt sends to the intersection kernel in
     the first chunk (2^15 paths) of BASELINE config 4 (Cornell "caustic",
     128x128, 8 spp, 4 bounces), recorded through its hooks in four groups:
     the 5 eye-walk and 5 light-walk closest-hit calls, the 10 connection
     and the 5 t=1 shadow calls; each call held to its plain version bit
     for bit (t and prim, or the occlusion booleans); per group the live
     share, the kernel's and plain times and the bound (a shadow ray's
     work ends at its first hit in the kernel's order).
 12. bdpt render: the config-4 path, tputracer_torch.api.render_bdpt; it
     must launch the intersection kernel 100 times (4 chunks x 25 calls)
     and the traversal, expand and pair-test kernels never, give a finite
     image whose mean is within 2% of the JAX package's and ray counts
     within rtol 1e-3 of its counts (BDPT_REF), L_own of the first chunk bit
     for bit that of the plain version's hooks on the card and the image
     at the golden tolerances of that render, and a 32x32 render at the
     golden tolerances of the CPU's.  Timed in turns with the plain hooks'
     render.  Then, each rendered once, counted and timed: 512x512 16 spp
     in chunks of 2^18 (peak memory), config 4 at 8 bounces, and
     mesh_scene(subdiv=4) at 64x64 4 spp through the traversal kernel.
 13. progressive: render_bdpt_progressive of config 4 in passes of 2 spp
     with a checkpoint, stopped after two passes and resumed, against the
     single-shot render (rtol 1e-4: the splat adds in no fixed order on
     the card); render_progressive of config 1's scene at 64x64 4 spp
     against render (rtol 1e-5).
 14. fit: the config-5 path, tputracer_torch.fit.fit of Cornell "boxes" at
     128x128, 4 spp, 3 bounces, rr_start=2, one chunk of 2^16 paths, from
     albedo x 0.5 and emission x 2 toward the true scene's image, Adam at
     1e-2: 24 steps in chains of 8 with a checkpoint every 8; it must
     launch the intersection kernel 7 times a step (4 closest-hit and 3
     shadow calls), 14 with remat (the backward pass recomputes each
     bounce), the other kernels never, and the sampler kernel 8 times a
     step (1 + 6 + 1 draws); the loss must fall.  Three
     identical grad_render calls must give the same gradient bits (the
     table lookups' backward is lookup.fetch's one-hot matmul, whose
     summation order the shapes fix); a fit stopped after 16 steps and
     resumed to 24 must equal the uninterrupted one bit for bit.  The
     plain hooks' loss and gradients bit for bit; the CPU's grad_render at
     32x32 (loss rtol 1e-6, gradients 1e-5 of the largest entry); remat's
     loss bit for bit and gradients at rtol 1e-5.  One fit step under
     torch.profiler: 4 B + 1 one-hot backwards a chunk and no
     IndexBackward0 (table[idx]'s own backward).  Chains of 8 timed with
     and without remat (steps/s, forward+backward rays/s).  A BDPT fit
     (boxes 64x64 4 spp 3 bounces, 6 steps: bdpt_launches(3) a step, the
     loss falls); grad_render on mesh_scene(subdiv=4) at 64x64 through the
     traversal kernel (7 launches, finite gradients); grad_render at
     256x256 16 spp 4 bounces in one chunk of 2^20 paths without and with
     remat, whose peak memory must be lower.
 15. dist: tputracer_torch.dist.  A world of one on NCCL in this process:
     render_sharded of config 1 (phase 4's bits, 36 intersection
     launches) and render_tiled of config 3 (phase 7's bits and ray
     counts, 68 traversal launches, no ring bytes).  Then worlds whose
     ranks are fresh interpreters (never a fork of this process, which
     holds a CUDA context) sharing the card over gloo, each killed after
     DIST_TIMEOUT_S; every rank checks itself against this process's
     references and any failure fails the phase.  P = 2: config 1 DP
     (phase 4's bits, 18 launches a rank); config 3 tiled (68 traversal
     launches a rank, ring_bytes' count, phase 7's image within rtol 2e-5
     and its ray counts; timed, once with each hop timed; the traversal
     kernel on the recorded second hops of a chunk's bounce-1 calls bit
     for bit against the clustered walk); config 4 DP (50 launches a
     rank, L_own bit for bit, the image within rtol 1e-4 of phase 12's)
     and the BDPT ring (35 launches a rank, within rtol 1e-4 of the
     emulation); config 5's DP step (7 launches, the single card's loss
     and gradients within 1e-5), a fit(mesh=) whose loss falls (timed on
     its second call) and a BDPT DP step at 64x64.  With two cards also
     P = 2 on NCCL, a card a rank, and the scaling efficiency.  Then the
     capacity scene (mesh_scene(subdiv=8, leaf_size=128), more clusters
     than the flat scan stages, so one launch takes the tree walk, which
     must give the plain walk's bits) tiled over P = 4 ranks from a host
     build, against the plain walk on the card.
 16. spheres: the config-2 path, api.render of Cornell "spheres" (a mirror
     and a glass sphere) at 256x256, 64 spp, 6 bounces, rr_start=3, in
     chunks of 2^20; it must launch the intersection kernel 52 times (4
     chunks x (7 closest + 6 shadow)) and the other kernels never, give a
     finite image with a mean in [0.15, 0.30], and the image and ray
     counts of the plain version's hooks (the torch route) bit for bit.
     Timed as phase 4 (the plain route's render once).
 17. graphs: the compiled entry points (tputracer_torch.graphs). Configs 1,
     2, 3 (B2, and the pair route with TPUTRACER_PAIRS=1), 4, and the
     progressive renders of configs 1 and 4 in passes of 4 spp, each through
     api.render / render_bdpt / render_progressive /
     render_bdpt_progressive, which run the first call of a key eagerly,
     capture a CUDA graph on the second and replay it after: each of the
     first calls (the eager one, the capture), counted, must launch 36, 52,
     68 (68 of each kernel on the pair route), 100, 36 and 100, and by the
     capture one graph must exist; its kernel nodes, read from the driver,
     times its replays in a call, and a torch.profiler trace of a call must
     hold those launches kernel by kernel (the fold kernel as often as the
     pair test; of up to 3 traces, none may hold more and one must hold them
     exactly, as CUPTI may drop a record); the capturing call's result and a
     replay's must be the eager counterpart's (render_pt,
     integrators.bdpt.render_bdpt, the progressive loop's eager passes) bit
     for bit, BDPT's ray counts bit for bit and its image within 1e-5; a
     material edited in place, then replaced by a tensor of the same shape,
     must replay without a capture and give the eager bits of the edited
     scene; a scene of other shapes must capture a new graph (on its second
     call) in the same pool; a table that requires grad must run eagerly (at
     1 spp) with its grad_fn and the eager bits. Timed in turns with the
     eager counterpart (median of 3 after the capture); the first call's and
     the capturing call's seconds, the capture, census and instantiate
     seconds, the graph's kernel and all nodes, its pool and what the second
     graph added to the shared pool, the copy-in (tensors, and its ms
     between CUDA events, timed here), the peak memory. Then config 4's
     trace_bdpt_rows through graphs.call: L_own and the ray counts bit for
     bit, 2 connection and 2 splat launches a chunk.
 18. sampler: the sampler kernel (csrc/rng.cu, rng.uniform3_cuda) against
     rng.uniform3_plain bit for bit at 2^16 and 2^20 lanes (and 2^20 + 5),
     uids over the whole int64 range, salts and seeds above 2^31; timed
     at 2^16 and 2^20 lanes of a render's uids (also as 20 calls inside a
     CUDA graph, graph_ms, which leaves out the host's work) beside its
     bound (20 bytes a lane) and the plain version.  Then configs 1 and 3
     through api.render (eager, capture, replay): each call must launch the
     kernel once a draw, the camera's one a chunk (the PT kernels draw the
     rest themselves), 4 times each, the eager and capturing calls' draws
     must all take the kernel (their rng.uniform3 spans), and the graph
     must hold those launches; a second graph of the same render with
     uniform3 on the torch route must hold none and give the same image
     and ray counts bit for bit; the two graphs' replays timed in turns.
 19. connect: BDPT's connection kernels (csrc/connect.cu,
     bdpt_cuda.connection_radiance_cuda) on a chunk of 2^20 paths of the
     caustics box at 4 bounces, against connection_radiance_plain bit for
     bit (the radiance and the shadow-ray count, balance and power
     heuristics); the two kernels (and their table fills) timed without
     shadow rays beside their bound (connect_bytes_per_lane over 3.35
     TB/s), the plain version likewise, and the whole connection phase
     (the 10 shadow-ray calls included) inside a CUDA graph.  Then the
     benchmark's frame (512x512, 16 spp, chunks of 2^20) through
     api.render_bdpt (eager, capture, replay): 8 launches a call
     (cuda_build.LAUNCHES of the two kernels), the graph holding 4 of each
     kernel.  Then BDPT's t = 1 splat kernels (the same source,
     bdpt_cuda.t1_splats_cuda) on that chunk against t1_splats_plain: the
     shadow-ray count bit for bit and the film within the bound of two
     orders of the same positive sums (splat_film_bound), and on a chunk
     of 128 paths, whose splats land on distinct pixels of a 4096^2 film,
     the film bit for bit; the two kernels timed without shadow rays
     beside their bound (splat_bytes_per_lane), the plain version
     likewise, and the whole splat phase (its 5 shadow-ray calls
     included) inside a CUDA graph; then the frame again: 8 splat
     launches a call, 4 of each kernel and 16 table fills in its graph.
 20. pt: PT's bounce kernels (csrc/pt.cu, pt_cuda.bounce_cuda) against
     _bounce_step_plain bounce by bounce from the same carry on chunks of
     2^20 paths of config 1 and config 2 (with MIS too) and a 2^16-path
     chunk of config 3's mesh through B2, the card's intersectors on both
     sides (pt_bounce_bits: L, alive, the ray counts and the next tmax
     bit for bit on every lane, the rest of the carry on every lane still
     alive; the largest difference seen is the kernels line's
     max_abs_err); the two kernels of a config-1 bounce timed inside a
     CUDA graph, their closest hit given and every shadow ray clear,
     beside the bytes that bounce's lanes need (pt_bytes of its own ray
     counts) and the torch version's shading of that bounce; then config
     1's frame through
     api.render (eager, capture, replay): 36 launches a call, the graph
     holding 20 prepare, 16 finish and 4 sampler kernels.
 21. capacity: the capacity scene (mesh_scene(subdiv=8), 18,304 clusters,
     past what the flat scan stages) built on the card, rendered through
     api.render at the mesh cell's settings (config 3's: 256x256, 4 spp,
     8 bounces, rr_start=3, chunks of 2^16), eager, capture and replay:
     68 tree-walk launches a call (cuda_build.LAUNCHES, zeroed before
     each), the graph's image the eager one's, and the walk's counters'
     boxes and clusters a ray.  Then every closest-hit and shadow call of
     the first chunk of that render (2^16 rays each, recorded through the
     integrator's hooks) through the tree walk against the plain walk
     (clustered._traverse in blocks of rays), t and prim bit for bit; on
     bounce 0's closest-hit call the walk timed alone and inside a CUDA
     graph, the plain walk timed, and the bound of the work any walk in
     (te, c) order does on those rays (perfbench/visit_bound.visit_work:
     a slab test of each cluster entered before the final hit, the slots'
     tests, each visited cluster's bytes once).
 22. walk: BDPT's walk kernel (csrc/walk.cu, bdpt_cuda.walk_cuda) against
     _walk_plain, both walks of a chunk of 2^20 paths of the caustics box
     at 4 bounces and of a 2^16-path chunk of config 3's mesh through B2,
     the card's intersector on both sides (walk_bits: every field of
     every vertex bit for bit on the lanes valid there, valid, delta,
     pdf_fwd, pdf_rev, mat and prim on every lane, rays_closest bit for
     bit; the largest difference seen is the kernels line's max_abs_err);
     trace_bdpt's L_own and ray counts on that chunk bit for bit between
     the kernel's walks and the torch walks (the walk phases counting
     kernel 1 and 0); the eye walk timed inside a CUDA graph, its closest
     hits given, beside the bytes its vertices' lanes need
     (walk_bytes_per_lane of each vertex's own counts) and _walk_plain's;
     then the benchmark's frame (512x512, 16 spp, chunks of 2^20) through
     api.render_bdpt (eager, capture, replay): 40 walk launches a call,
     the graph holding 40 walk kernels.

Phases 4, 7, 10, 12, 13 and 16 go through the same entry points, whose
first call of a key runs eagerly, so their counted calls are eager ones;
the script drops the graphs between phases (graphs.clear()).

A kernel's ``ms`` times one call alone between CUDA events, the wrapper's
host work included (cuda_ms: the median of 5 after 2 warm-ups);
``device_ms`` is the card's time per call over 20 calls back to back.

Then the script's wall time, a JSON line of per-kernel results (each kernel's launches on its main
path, times, and bound: the larger of the bytes it must move over 3.35
TB/s and the float ops this run's data needs over 33.5 T ops/s, the
card's 67 TFLOP/s float32 rate without fused multiply-adds, which the
kernels are built without), the card's name and power limit, and last
{"ok": true, "device": {...}}.  Any failure raises and the script
exits non-zero without that last line; there is no CPU fallback.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

N_RAYS = 1 << 20
N_CHUNK = 1 << 16     # rays per traversal call in a config-3 render
BIG = 3.0e38
# BASELINE config 2 (benchmarks/run.py:97-106): cornell_box("spheres"), a
# mirror and a glass sphere; chunks of 2^20, RenderConfig's default
SPHERES_CFG = dict(width=256, height=256, spp=64, max_bounces=6, rr_start=3,
                   chunk_size=1 << 20)
# BASELINE config 3 (benchmarks/run.py): mesh_scene(subdiv=6)
MESH_CFG = dict(width=256, height=256, spp=4, max_bounces=8, rr_start=3,
                chunk_size=1 << 16)
# BASELINE config 4 (benchmarks/run.py): cornell_box("caustic"), BDPT
BDPT_CFG = dict(width=128, height=128, spp=8, max_bounces=4,
                chunk_size=1 << 15)
# the JAX package's render_bdpt of BDPT_CFG on the CPU (tputracer.api.
# render_bdpt(cornell_box("caustic"), BdptConfig(**BDPT_CFG)) with
# JAX_PLATFORMS=cpu, jax 0.9.0; the image mean and stats["rays_closest"],
# stats["rays_shadow"]): correctness references, not speeds
BDPT_REF = {"mean": 0.035571251064538956, "rays_closest": 960_467.0,
            "rays_shadow": 927_030.0}
# BASELINE config 5 (benchmarks/run.py:187-247): cornell_box("boxes"),
# inverse rendering from albedo x 0.5 and emission x 2 toward the true
# scene's image, Adam at 1e-2, chains of 8 steps
FIT_CFG = dict(width=128, height=128, spp=4, max_bounces=3, rr_start=2,
               chunk_size=1 << 16)
FIT_LR = 1e-2
FIT_K = 8


# the H100's float32 rate without fused multiply-adds (its 67 TFLOP/s
# counts an FMA as two ops) and its memory rate (SXM data sheet)
PEAK_OPS = 33.5e12
PEAK_BYTES = 3.35e12
# float ops of one test, counted from the CUDA sources: a cluster slab
# (6 sub, 6 mul, 12 min/max, 4 compares); a Pluecker + plane triangle test
# (three 6-term dots, 6 sign compares, two 3-term dots, 6 more), of which
# the edge part (the dots and compares, OPS_EDGES) is needed for every
# pair and the plane part only where the three edge signs agree; a sphere
# (csrc/intersect.cu); a Moeller-Trumbore test (csrc/pairs.cu) in the
# stages a slot reaches: the determinant (p = d x e2: 6 mul, 3 sub;
# e1.p: 3 mul, 2 add; |det| > 1e-12: 2) for every slot, then where
# |det| > 1e-12 1/det, s = o - v0 and u (1 div, 3 sub, 3 mul, 2 add, 1 mul,
# 2 compares for 0 <= u <= 1), then past the u test q = s x e1, v, t and
# their tests (9, 6, 6, then u + v, 4 compares and the running minimum's)
OPS_SLAB = 26
OPS_PLANE = 56
OPS_EDGES = 39
OPS_SPHERE = 24
OPS_MT_DET = 16
OPS_MT_U = 12
OPS_MT_T = 27


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


def build_seconds(source):
    """Seconds of the last load of ``csrc/<source>`` that ran nvcc (its
    ``build.<source>`` span), or None if it came from the cache."""
    from tputracer_torch import trace

    built = [r for r in trace.records(f"build.{source}")
             if r.counts.get("compiled")]
    return built[-1].ms / 1e3 if built else None


def capture_seconds():
    """The last graph capture's seconds, whole and its census's and
    instantiation's, from their spans' records."""
    from tputracer_torch import trace

    cap = trace.records("graphs.capture")[-1]
    out = {"capture_s": cap.ms / 1e3}
    for part in ("census", "instantiate"):
        out[f"{part}_s"] = next(r.ms / 1e3
                                for r in trace.records(f"graphs.{part}")
                                if r.parent == cap.id)
    return out


def phase_build():
    from tputracer_torch import cuda_build, rng
    from tputracer_torch.accel import bvh
    from tputracer_torch.accel import intersect_cuda as ic
    from tputracer_torch.accel import pairs_cuda as pc
    from tputracer_torch.accel import traverse_cuda as tc
    from tputracer_torch.integrators import bdpt_cuda, pt_cuda
    from tputracer_torch.scene import mesh_scene

    libs = (ic.LIB, tc.LIB, pc.LIB, rng.LIB, bdpt_cuda.LIB, pt_cuda.LIB,
            bdpt_cuda.WALK_LIB)
    sources = tuple(lib.source for lib in libs)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:   # one nvcc per source
        for job in [pool.submit(lib.load) for lib in libs]:
            job.result()
    nvcc_s = time.perf_counter() - t0
    ptxas = {src: [ln.strip() for ln in
                   cuda_build.BUILD_LOG.get(src, "").splitlines()
                   if "registers" in ln or "spill" in ln]
             for src in sources}
    t0 = time.perf_counter()
    mesh = mesh_scene(subdiv=6, device="cuda")
    emit("build", seconds=round(nvcc_s, 3),
         nvcc_seconds={k: build_seconds(k) for k in sources},
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


def recording_hooks():
    """(closest, shadow, isect, occl): intersect_fn and occluded_fn hooks
    for an integrator that pass each call on to accel.intersect and
    accel.occluded (the kernel on the card) and append a contiguous copy
    of its rays to ``closest`` as (o, d, tmin, tmax) or to ``shadow`` as
    (o, d, 0, tmax)."""
    from tputracer_torch.accel import intersect, occluded

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

    return closest, shadow, isect, occl


def bounce_rays(scene, cfg, bounce):
    """The rays of bounce ``bounce`` of the first chunk of a render of
    ``scene`` at ``cfg``, recorded through trace_radiance's hooks
    (recording_hooks).  Returns the closest-hit rays (o, d, tmin, tmax)
    and the shadow rays (o, d, 0, tmax)."""
    from tputracer_torch.integrators.pt import trace_radiance

    closest, shadow, isect, occl = recording_hooks()
    n = min(cfg.chunk_size, cfg.width * cfg.height * cfg.spp)
    uid = torch.arange(n, dtype=torch.int64, device=scene.device)
    trace_radiance(scene, uid, cfg, intersect_fn=isect, occluded_fn=occl)
    return closest[bounce], shadow[bounce]


def intersect_work(o, d, live, args):
    """(ops, bytes, agree_share) of a closest-hit call on this data: every
    live ray tests every sphere and runs the edge part of every valid
    triangle's test, and the plane part only where the three edge signs
    agree, as the plain version's pos | neg mask says on the same inputs;
    each ray's 40 bytes and each table read once.  agree_share: the share
    of (live ray, valid triangle) pairs whose signs agree."""
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
    return (ops, 40 * live.numel() + 4 * sum(x.numel() for x in args),
            agree / pairs if pairs else 0.0)


def intersect_bound(o, d, live, args):
    """(bound_ms, bound_by, agree_share) of a closest-hit call on this
    data, from intersect_work."""
    ops, nbytes, agree_share = intersect_work(o, d, live, args)
    return (*bound(ops, nbytes), agree_share)


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
    zero_counts()
    img, stats = render(scene, cfg, device="cuda")
    torch.cuda.synchronize()
    launches = launch_counts()["fused_intersect"]
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
        # injected hooks send the render down the torch route: the plain
        # intersector and the torch shading, a whole route against the
        # kernels' (B1 and csrc/pt.cu)
        render_pt(sc, cfg, intersect_fn=intersect_plain,
                  occluded_fn=occluded_plain)

    kernel_run()   # warm-up
    plain_run()
    kernel_s, plain_s = [], []
    for _ in range(3):   # in turns, so drift hits both alike
        kernel_s.append(cuda_ms(kernel_run, 0, 1) / 1e3)
        plain_s.append(cuda_ms(plain_run, 0, 1) / 1e3)
    render_s = statistics.median(kernel_s)
    plain_route_render_s = statistics.median(plain_s)
    flat = n_paths * (2 * cfg.max_bounces + 1)
    emit("render", config="boxes 512x512 16spp 4 bounces", launches=launches,
         mean=mean, render_s=render_s, render_s_all=kernel_s,
         flat_rays_per_s=flat / render_s,
         issued_rays=issued, issued_rays_per_s=issued / render_s,
         plain_route_render_s=plain_route_render_s,
         plain_route_render_s_all=plain_s,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return launches, img.cpu().numpy()


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


def run_rays(sc, n_run, n_single, seed, device="cuda"):
    """Rays whose (ray, cluster) pairs sort into long runs of one cluster
    beside runs of a single pair: n_run rays from one corner of
    mesh_scene's room aimed near the middle of one cluster's box, then
    n_single rays as room_rays draws them.  A quarter of the lanes dead;
    occlusion distances up to 6."""
    rng = np.random.default_rng(seed)
    lo, hi = (x.cpu().numpy().astype(np.float64)
              for x in (sc.clus_min, sc.clus_max))
    c = rng.integers(0, lo.shape[0])
    aim = lo[c] + rng.uniform(0.4, 0.6, (n_run, 3)) * (hi[c] - lo[c])
    o = np.concatenate([np.tile([1.8, 2.8, 1.8], (n_run, 1)), rng.uniform(
        (-1.9, 0.05, -1.9), (1.9, 2.9, 1.9), (n_single, 3))])
    d = np.concatenate([aim - o[:n_run], rng.normal(size=(n_single, 3))])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    n = n_run + n_single
    tmax = np.full(n, BIG)
    tmax[::4] = 0.0
    tocc = np.where(tmax > 0.0, rng.uniform(0.0, 6.0, n), 0.0)
    return tuple(torch.from_numpy(np.asarray(x, np.float32)).to(device)
                 for x in (o, d, np.zeros(n), tmax, tocc))


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


def edge_agree(o, d, c, plu, valid, leaf):
    """How many valid slots of cluster c[i] have ray i's three edge signs
    agree, as the plain walk's _tri_block computes the signs."""
    from tputracer_torch.accel.bruteforce import edge_volume, ray_features

    lane = torch.arange(leaf, device=o.device)
    agree = 0
    for p0 in range(0, c.numel(), 1 << 12):
        ps = slice(p0, p0 + (1 << 12))
        slots = c[ps, None].long() * leaf + lane
        blk = plu[:, :, slots].transpose(1, 2)         # (3, P, 6, leaf)
        feat = ray_features(o[ps], d[ps])
        w0, w1, w2 = (edge_volume(feat, blk[e]) for e in range(3))
        pos = (w0 >= 0.0) & (w1 >= 0.0) & (w2 >= 0.0)
        neg = (w0 <= 0.0) & (w1 <= 0.0) & (w2 <= 0.0)
        agree += int(((pos | neg) & valid[slots]).sum())
    return agree


def walk_bound(o, d, tmin, tmax, t_final, args, leaf):
    """Least work of a closest-hit walk on this data: one slab scan of all
    C boxes per live ray; the edge part of the test for every valid slot
    of each cluster entered before the ray's final hit, and the plane part
    only where the three edge signs agree, counted from the plain walk's
    signs on the same rays.  Returns (bound_ms, bound_by, counts): the
    clusters each live ray admits (least, mean, most) and enters before
    its final hit, which the walk visits (mean, most), the share of live
    rays with two or more entries at te = 0, and the agree share of the
    (ray, valid slot) tests."""
    from tputracer_torch.accel import clustered as cl

    cmin, cmax, plu, mask = args[0], args[1], args[2], args[5]
    C, T = cmin.shape[0], plu.shape[2]
    valid_slot = mask > 0
    valid = valid_slot.float().reshape(C, leaf).sum(1)
    live = tmax > tmin
    tests, agree = 0.0, 0
    adm, seen_n, zero = [], [], []
    for r0 in range(0, o.shape[0], 1 << 13):
        rs = slice(r0, r0 + (1 << 13))
        te = cl.cluster_entries(o[rs], d[rs], tmin[rs], tmax[rs], cmin, cmax)
        seen = (te < t_final[rs, None]) & live[rs, None]
        tests += float((seen.float() @ valid).sum())
        ray, c = torch.nonzero(seen, as_tuple=True)
        agree += edge_agree(o[rs][ray], d[rs][ray], c, plu, valid_slot, leaf)
        adm.append((te < BIG).sum(1)[live[rs]])
        seen_n.append(seen.sum(1)[live[rs]])
        zero.append((te == 0.0).sum(1)[live[rs]])
    ops = (float(live.sum()) * C * OPS_SLAB + tests * OPS_EDGES
           + agree * (OPS_PLANE - OPS_EDGES))
    nbytes = 4 * (12 * o.shape[0] + 6 * C + 23 * T)
    adm, seen_n = torch.cat(adm).float(), torch.cat(seen_n).float()
    counts = {"admitted_min": int(adm.min()), "admitted_mean":
              float(adm.mean()), "admitted_max": int(adm.max()),
              "visited_mean": float(seen_n.mean()),
              "visited_max": int(seen_n.max()), "zero_tie_share":
              float((torch.cat(zero) >= 2).float().mean()),
              "agree_share": agree / tests if tests else 0.0}
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
    (accel.pairs._pair_traverse), closest hit from bt0 = tmax: every ray
    in its own order, the ones the K slots resolve at tmax = 0, each
    starting from the slots' best.  Returns (inputs, unresolved)."""
    from tputracer_torch.accel import pairs

    bt0 = tmax.clone()
    bp0 = torch.full(tmax.shape, -1, dtype=torch.int32, device=o.device)
    best_t, best_p, resolved = pairs._slot_best(sc, o, d, tmin, tmax, bt0,
                                                bp0, False)
    walk_in = (o, d, tmin, torch.where(resolved, 0.0, tmax), best_t, best_p)
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

    # the pair route's fallback call
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
    from tputracer_torch.api import render
    from tputracer_torch.config import RenderConfig
    from tputracer_torch.integrators.pt import render_pt

    cfg = RenderConfig(**MESH_CFG)
    n_paths = cfg.width * cfg.height * cfg.spp
    n_chunks = -(-n_paths // cfg.chunk_size)
    want = n_chunks * (2 * cfg.max_bounces + 1)

    # the config-3 path, counted: exactly this one call to render
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    img, stats = render(mesh, cfg, device="cuda")
    torch.cuda.synchronize()
    counts = launch_counts()
    launches, fused = counts["traverse"], counts["fused_intersect"]
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
    # the torch route, which injected hooks take: the plain walk in B2's
    # place and the torch shading in csrc/pt.cu's; one run, not a median
    plain_s = cuda_ms(lambda: render_pt(
        sc, cfg, intersect_fn=intersect_clustered,
        occluded_fn=occluded_clustered), 0, 1) / 1e3
    flat = n_paths * (2 * cfg.max_bounces + 1)
    emit("mesh_render", config="mesh subdiv=6 256x256 4spp 8 bounces rr 3",
         launches=launches, fused_launches=fused, mean=mean,
         render_s=render_s, render_s_all=kernel_s,
         flat_rays_per_s=flat / render_s, issued_rays=issued,
         issued_rays_per_s=issued / render_s,
         plain_route_render_s_once=plain_s, peak_mem_gb=peak_gb)
    return launches, img.cpu().numpy(), {k: v.cpu().numpy()
                                         for k, v in stats.items()}


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
    check(bool((img_k == img_p).all()),
          "32x32 mesh render: the kernels' image is not the plain route's, "
          "bit for bit")


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


def mt_stages(o, d, tmin, bt0, sidx, cid, te, v0, e1, e2, mask, leaf):
    """The Moeller-Trumbore stages the pair test's (wanted slot, valid leaf
    slot) tests reach, from the plain version's arithmetic on the same
    inputs: {"wanted": slots, "det": tests, "u": tests past |det| > 1e-12,
    "t": tests past the u test as well}."""
    from tputracer_torch.accel import pairs

    k = cid.shape[1]
    ray = sidx // k
    c = cid.reshape(-1)[sidx]
    want = (c >= 0) & (te.reshape(-1)[sidx] < bt0[ray])
    ray, c = ray[want], c[want].long()
    lane = torch.arange(leaf, device=o.device)
    out = {"wanted": int(want.sum()), "det": 0, "u": 0, "t": 0}
    for p0 in range(0, c.numel(), 1 << 14):
        ps = slice(p0, p0 + (1 << 14))
        slots = c[ps, None] * leaf + lane
        ok, u, _, _ = pairs._mt(o[ray[ps]], d[ray[ps]], slots, v0, e1, e2)
        valid = mask[slots] > 0.0
        ok = ok & valid
        out["det"] += int(valid.sum())
        out["u"] += int(ok.sum())
        out["t"] += int((ok & (u >= 0.0) & (u <= 1.0)).sum())
    return out


def tie_pairs(device="cuda"):
    """A constructed pair-test case and the folded answer it must give.
    Two clusters of 4 slots: cluster 0 holds two triangles in the plane
    z = 1 side by side (slots 1 and 3), cluster 1 a copy of slot 1 (slot 5)
    and a triangle at z = 2 (slot 6); slots 0, 2, 4 and 7 are masked.
    Ray 0 hits the copies in its slots 0 and 1 (clusters 1 and 0) at the
    same t, so the lower slot wins, prim 5 over prim 1; ray 1's slots never
    beat its bt0 (a sphere at t = 0.5), so it keeps (bt0, bp0); ray 2 has
    no slot; ray 3 hits only cluster 1's far triangle, in its slot 1.
    Returns (pairtest_plain's arguments, leaf, (best_t, best_p))."""
    from tputracer_torch.accel import pairs

    tris = np.zeros((8, 3, 3), np.float32)
    tris[1] = [[0, 0, 1], [1, 0, 1], [0, 1, 1]]
    tris[3] = [[-1, -1, 1], [0, -1, 1], [-1, 0, 1]]
    tris[5] = tris[1]
    tris[6] = [[-2, -2, 2], [2, -2, 2], [-2, 2, 2]]
    v0 = tris[:, 0]
    big = float(np.float32(BIG))

    def tensor(x, dtype=torch.float32):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    cid = tensor([[1, 0], [0, 1], [-1, -1], [0, 1]], torch.int32)
    args = (tensor([[0.25, 0.25, 0.0], [0.25, 0.25, 0.0], [0.0, 0.0, 0.0],
                    [-1.5, -1.5, 0.0]]),
            tensor([[0.0, 0.0, 1.0]] * 4), tensor(np.zeros(4)),
            tensor([big, 0.5, big, big]),
            tensor([-1, 99, -1, -1], torch.int32),
            pairs.cluster_order(cid, 2), cid,
            tensor([[0.9, 0.9], [0.9, 0.9], [big, big], [0.9, 1.5]]),
            tensor(v0), tensor(tris[:, 1] - v0), tensor(tris[:, 2] - v0),
            tensor([0, 1, 0, 1, 0, 1, 1, 0]))
    return args, 4, ([1.0, 0.5, big, 2.0], [5, 99, -1, 6])


def pairs_case(name, sc, rays, any_hit, timed, route=True):
    """The expand and pair-test kernels against their plain versions on one
    ray set and mode, bit for bit, and with ``route`` the whole pair route
    against the traversal kernel; with ``timed``, each timed beside its
    bound."""
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

    # the pair test and fold on the route's own inputs
    sidx = pairs.cluster_order(cid, C)
    pargs = (o, d, tmin, bt0, bp0, sidx, cid, te, v0, e1, e2, mask)

    def test_k():
        return pc.pairtest_cuda(*pargs, leaf=leaf)

    def test_p():
        return pairs.pairtest_plain(*pargs, leaf=leaf)

    t_k, p_k = test_k()
    t_p, p_p = test_p()
    torch.cuda.synchronize()
    res["pairtest_mismatch"] = {
        "t": int((t_k.view(torch.int32) != t_p.view(torch.int32)).sum()),
        "p": int((p_k != p_p).sum())}
    check(sum(res["pairtest_mismatch"].values()) == 0,
          f"pairs {name}: pair test differs from its plain version "
          f"{res['pairtest_mismatch']}")
    res["pairtest_max_abs_err"] = float((t_k - t_p).abs().max()) if n else 0.0
    res["improved_share"] = float((t_p < bt0).float().mean()) if n else 0.0
    stages = mt_stages(o, d, tmin, bt0, sidx, cid, te, v0, e1, e2, mask,
                       leaf)
    res["pairs"] = n * k
    res["wanted_pairs"] = stages["wanted"]
    if not route:
        return res

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

    res["expand_bound_ms"], res["expand_bound_by"] = bound(
        float(live.sum()) * C * OPS_SLAB,
        4 * (n * (8 + 2 * k + 1) + 6 * C))
    # each slot's cid, te and place in sidx (16 bytes); each ray's o, d,
    # tmin, bt0, bp0 and (t, p); the triangle tables once
    res["pairtest_bound_ms"], res["pairtest_bound_by"] = bound(
        stages["det"] * OPS_MT_DET + stages["u"] * OPS_MT_U
        + stages["t"] * OPS_MT_T,
        4 * n * k * 4 + 4 * n * 11 + 4 * 10 * mask.shape[0])
    res["mt_stage_shares"] = {
        key: stages[key] / stages["det"] if stages["det"] else 0.0
        for key in ("u", "t")}
    for key, fn in (("expand", expand_k), ("pairtest", test_k),
                    ("route", route), ("traverse", walk)):
        res[f"{key}_ms"] = cuda_ms(fn, 2, 5)
        res[f"{key}_device_ms"] = device_ms(fn)
    res["expand_plain_ms"] = cuda_ms(expand_p, 1, 3)
    res["pairtest_plain_ms"] = cuda_ms(test_p, 1, 3)
    if not any_hit:
        res["traverse_bound_ms"], res["traverse_bound_by"], counts = \
            walk_bound(o, d, tmin, tmax, t_w, targs, leaf)
        res["traverse_agree_share"] = counts["agree_share"]
    return res


def phase_pairs(mesh):
    """The pair route's two kernels against their plain versions, and the
    route against the traversal kernel, at config-3 chunk sizes."""
    from tputracer_torch.accel import pairs
    from tputracer_torch.accel import pairs_cuda as pc
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
    # long runs of one cluster beside runs of a single pair, for the
    # kernels (the route's rays, aimed at one spot, tie more often than
    # the random sets' bound on ties allows)
    emit("pairs", **pairs_case("runs", mesh, run_rays(mesh, 30_000, 64,
                                                      seed=13), False,
                               timed=False, route=False))
    # a constructed tie between two slots of a ray, and a ray whose slots
    # never beat its bt0: the folded answer is known
    args, leaf, (want_t, want_p) = tie_pairs()
    t_k, p_k = pc.pairtest_cuda(*args, leaf=leaf)
    t_p, p_p = pairs.pairtest_plain(*args, leaf=leaf)
    got = {"kernel": [t_k.tolist(), p_k.tolist()],
           "plain": [t_p.tolist(), p_p.tolist()]}
    emit("pairs", rays="constructed tie", n_rays=len(want_p), **got)
    check(all(v == [want_t, want_p] for v in got.values()),
          f"pairs constructed tie: {got}, want {[want_t, want_p]}")
    return results


def phase_pairs_render(mesh, default_img):
    """The config-3 render through the pair route (TPUTRACER_PAIRS=1, set
    for this phase only), counted, checked and timed in turns with the
    default route."""
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
        zero_counts()
        img, stats = render(mesh, cfg, device="cuda")
        torch.cuda.synchronize()
        counts = launch_counts()
        launches = {"expand": counts["pair_expand"],
                    "pair_test": counts["pair_test"],
                    "traverse": counts["traverse"],
                    "fused_intersect": counts["fused_intersect"]}
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


def bdpt_launches(max_bounces):
    """Intersection calls of one BDPT chunk: 2 (B + 1) closest-hit walk
    steps, B (B + 1) / 2 connection and B + 1 t=1 shadow calls."""
    b = max_bounces
    return 2 * (b + 1) + b * (b + 1) // 2 + (b + 1)


def bdpt_rays(scene, cfg, n):
    """The rays of the first chunk (n paths) of a BDPT render of ``scene``
    at ``cfg``, recorded through trace_bdpt's hooks (recording_hooks).
    Returns {group: [(o, d, tmin, tmax), ...]} for the groups "eye walk"
    and "light walk" (closest hit) and "connections" and "t=1" (shadow
    rays, tmin = 0)."""
    from tputracer_torch.integrators.bdpt import trace_bdpt

    closest, shadow, isect, occl = recording_hooks()
    uid = torch.arange(n, dtype=torch.int64, device=scene.device)
    trace_bdpt(scene, uid, cfg, intersect_fn=isect, occluded_fn=occl)
    e, b = cfg.max_bounces + 1, cfg.max_bounces
    conn = b * (b + 1) // 2
    check(len(closest) == 2 * e and len(shadow) == conn + b + 1,
          f"trace_bdpt made {len(closest)} closest-hit and {len(shadow)} "
          f"shadow calls")
    return {"eye walk": closest[:e], "light walk": closest[e:],
            "connections": shadow[:conn], "t=1": shadow[conn:]}


def any_hit_work(o, d, tmax, args):
    """(ops, bytes) of an any-hit call on this data, in intersect_work's
    accounting: a live ray stops at its first hit in the kernel's order
    (spheres, then the valid triangles by slot), so it tests the spheres
    up to its first hit sphere and, with none, the valid triangles up to
    its first hit, the plane part only where the edge signs agree."""
    from tputracer_torch.accel.bruteforce import edge_volume, ray_features

    sph_c, sph_r, plu, trin, tri_v0, mask = args
    live = tmax > 0.0
    o, d, tmax = o[live], d[live], tmax[live]
    n, S, T = o.shape[0], sph_c.shape[0], plu.shape[2]
    sph_tests = torch.full((n,), S, device=o.device)
    done = torch.zeros((n,), dtype=torch.bool, device=o.device)
    for s in range(S):
        oc = o - sph_c[s]
        b = (oc * d).sum(1)
        disc = b * b - ((oc * oc).sum(1) - sph_r[s] * sph_r[s])
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t = torch.where(-b - sq > 0.0, -b - sq, -b + sq)
        hit = (disc > 0.0) & (t > 0.0) & (t < tmax) & ~done
        sph_tests = torch.where(hit, s + 1, sph_tests)
        done |= hit
    feat = ray_features(o, d)
    v0n = (tri_v0 * trin).sum(1)
    hits, agrees = [], []
    for b0 in range(0, T, 128):
        sl = slice(b0, b0 + 128)
        w0, w1, w2 = (edge_volume(feat, plu[e, :, sl].T) for e in range(3))
        agree = (((w0 >= 0.0) & (w1 >= 0.0) & (w2 >= 0.0))
                 | ((w0 <= 0.0) & (w1 <= 0.0) & (w2 <= 0.0)))
        dn = d @ trin[sl].T
        t = (v0n[sl] - o @ trin[sl].T) / torch.where(dn.abs() > 1e-12, dn,
                                                      1.0)
        hits.append(agree & (dn.abs() > 1e-12) & (t > 0.0)
                    & (t < tmax[:, None]) & (mask[sl] > 0.0))
        agrees.append(agree)
    hit, agree = torch.cat(hits, 1), torch.cat(agrees, 1)
    first = torch.where(hit.any(1), hit.int().argmax(1), T)
    tested = ((torch.arange(T, device=o.device) <= first[:, None])
              & (mask > 0.0) & ~done[:, None])
    ops = (float(tested.sum()) * OPS_EDGES
           + float((tested & agree).sum()) * (OPS_PLANE - OPS_EDGES)
           + float(sph_tests.sum()) * OPS_SPHERE)
    return ops, 40 * live.numel() + 4 * sum(x.numel() for x in args)


def phase_bdpt_kernel():
    """The intersection kernel against its plain version on the rays of
    config 4's first chunk, group by group; each group timed beside its
    bound.  Returns the groups' results and the largest t error."""
    from tputracer_torch.accel import intersect_cuda as ic
    from tputracer_torch.config import BdptConfig
    from tputracer_torch.scene import cornell_box

    scene = cornell_box("caustic", device="cuda")
    args = ic.scene_args(scene)
    cfg = BdptConfig(**BDPT_CFG)
    results = []
    for group, calls in bdpt_rays(scene, cfg, cfg.chunk_size).items():
        any_hit = group in ("connections", "t=1")
        ops = nbytes = 0.0
        mism = {"prim": 0, "t": 0} if not any_hit else {"occluded": 0}
        n_rays = n_live = 0
        for o, d, tmin, tmax in calls:
            t_k, p_k = ic.fused_intersect_cuda(o, d, tmin, tmax, *args,
                                               any_hit=any_hit)
            t_p, p_p = ic.fused_intersect_plain(o, d, tmin, tmax, *args)
            if any_hit:
                mism["occluded"] += int(((t_k < tmax) != (t_p < tmax)).sum())
                w_ops, w_bytes = any_hit_work(o, d, tmax, args)
            else:
                mism["prim"] += int((p_k != p_p).sum())
                mism["t"] += int((t_k.view(torch.int32)
                                  != t_p.view(torch.int32)).sum())
                w_ops, w_bytes, _ = intersect_work(o, d, tmax > tmin, args)
            ops += w_ops
            nbytes += w_bytes
            n_rays += o.shape[0]
            n_live += int((tmax > tmin).sum())
        check(sum(mism.values()) == 0,
              f"bdpt {group}: the kernel differs from the plain version "
              f"{mism}")

        def kernel(calls=calls, any_hit=any_hit):
            for rays in calls:
                ic.fused_intersect_cuda(*rays, *args, any_hit=any_hit)

        def plain(calls=calls):
            for rays in calls:
                ic.fused_intersect_plain(*rays, *args)

        res = {"group": group, "calls": len(calls), "n_rays": n_rays,
               "mode": "any" if any_hit else "closest",
               "live_share": n_live / n_rays, "mismatch": mism}
        res["bound_ms"], res["bound_by"] = bound(ops, nbytes)
        res["ms"] = cuda_ms(kernel, 2, 5)
        res["device_ms"] = device_ms(kernel)
        res["plain_ms"] = cuda_ms(plain, 1, 3)
        results.append(res)
        emit("bdpt_kernel", **res)
    return results


# the intersection routes' kernels, by the names this script gives their
# launch counts
COUNTER_OF = {"fused_intersect_kernel": "fused_intersect",
              "traverse_kernel": "traverse", "expand_kernel": "pair_expand",
              "pairtest_kernel": "pair_test"}


def launch_counts():
    """cuda_build's launch counts of the four kernels, read now."""
    from tputracer_torch.cuda_build import LAUNCHES

    return {c: LAUNCHES[k] for k, c in COUNTER_OF.items()}


def zero_counts():
    """Set cuda_build's launch counts of the four kernels to 0."""
    from tputracer_torch.cuda_build import LAUNCHES

    for k in COUNTER_OF:
        LAUNCHES[k] = 0


def sampler_launches():
    """cuda_build's launch count of the sampler kernel."""
    from tputracer_torch.cuda_build import LAUNCHES

    return LAUNCHES["uniform3_kernel"]


def connect_launches():
    """cuda_build's launch counts of the two connection kernels, summed
    (their table fills are not counted)."""
    from tputracer_torch.cuda_build import LAUNCHES

    return (LAUNCHES["connect_prepare_kernel"]
            + LAUNCHES["connect_finish_kernel"])


def splat_launches():
    """cuda_build's launch counts of the two splat kernels, summed (their
    table fills are not counted)."""
    from tputracer_torch.cuda_build import LAUNCHES

    return LAUNCHES["splat_prepare_kernel"] + LAUNCHES["splat_finish_kernel"]


def bdpt_once(name, scene, cfg, want):
    """One counted render_bdpt of ``scene`` at ``cfg``, timed, that must
    give a finite image and launch the kernels ``want`` times."""
    from tputracer_torch.api import render_bdpt

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    start = time.perf_counter()
    img, stats = render_bdpt(scene, cfg, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = launch_counts()
    check(launches == want, f"bdpt {name}: launched {launches}, want {want}")
    check(bool(torch.isfinite(img).all()), f"bdpt {name}: non-finite pixels")
    res = {"config": name, "launches": launches, "render_s_once": seconds,
           "mean": float(img.mean()),
           "issued_rays": float(stats["rays_closest"] + stats["rays_shadow"]),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit("bdpt_render", **res)
    return res


def phase_bdpt_render():
    """The config-4 path: api.render_bdpt of the caustics scene, counted,
    checked against the JAX package's references and the plain version's
    hooks, timed; then the 512x512, 8-bounce and mesh renders."""
    from tputracer_torch.accel import intersect_plain, occluded_plain
    from tputracer_torch.api import render_bdpt
    from tputracer_torch.config import BdptConfig
    from tputracer_torch.integrators import bdpt
    from tputracer_torch.scene import cornell_box, mesh_scene

    scene = cornell_box("caustic", device="cuda")
    cfg = BdptConfig(**BDPT_CFG)
    n_paths = cfg.width * cfg.height * cfg.spp
    n_chunks = n_paths // cfg.chunk_size
    want = dict(fused_intersect=n_chunks * bdpt_launches(cfg.max_bounces),
                traverse=0, pair_expand=0, pair_test=0)

    # the main path, counted: exactly this one call to render_bdpt
    zero_counts()
    img, stats = render_bdpt(scene, cfg, device="cuda")
    torch.cuda.synchronize()
    launches = launch_counts()
    check(launches == want, f"bdpt render launched {launches}, want {want}")
    check(tuple(img.shape) == (cfg.height, cfg.width, 3),
          f"bdpt image shape {tuple(img.shape)}")
    check(bool(torch.isfinite(img).all()), "bdpt image has non-finite pixels")
    mean = float(img.mean())
    check(abs(mean / BDPT_REF["mean"] - 1.0) < 0.02,
          f"bdpt image mean {mean}, the JAX package's {BDPT_REF['mean']}")
    rays = {k: float(stats[k]) for k in ("rays_closest", "rays_shadow")}
    for k, v in rays.items():
        check(abs(v / BDPT_REF[k] - 1.0) <= 1e-3,
              f"bdpt {k} {v}, the JAX package's {BDPT_REF[k]}")

    # the first chunk through the plain version's hooks: L_own bit for bit
    uid = torch.arange(cfg.chunk_size, dtype=torch.int64,
                       device=scene.device)
    L_k, sp_k, _ = bdpt.trace_bdpt(scene, uid, cfg)
    L_p, sp_p, _ = bdpt.trace_bdpt(scene, uid, cfg,
                                   intersect_fn=intersect_plain,
                                   occluded_fn=occluded_plain)
    check(torch.equal(L_k, L_p),
          "bdpt chunk: L_own differs from the plain version's hooks")
    # the splat's index_add_ sums in no fixed order on the card
    splat_err = float(((sp_k - sp_p).abs() / (1.0 + sp_p.abs())).max())
    check(splat_err < 1e-5, f"bdpt chunk: splat differs from the plain "
                            f"version's hooks by {splat_err} (rel)")
    img_p, _ = bdpt.render_bdpt(scene, cfg, intersect_fn=intersect_plain,
                                occluded_fn=occluded_plain)
    parity = [golden_compare("plain on card", img.cpu().numpy(),
                             img_p.cpu().numpy())]
    small = BdptConfig(width=32, height=32, spp=4, max_bounces=4)
    img_cpu, _ = render_bdpt(cornell_box("caustic", device="cpu"), small)
    img_card, _ = render_bdpt(scene, small)
    parity.append(golden_compare("cpu render 32x32", img_card.cpu().numpy(),
                                 img_cpu.numpy()))

    def kernel_run():
        bdpt.render_bdpt(scene, cfg)

    def plain_run():
        bdpt.render_bdpt(scene, cfg, intersect_fn=intersect_plain,
                         occluded_fn=occluded_plain)

    kernel_run()   # warm-up
    plain_run()
    kernel_s, plain_s = [], []
    for _ in range(3):   # in turns, so drift hits both alike
        kernel_s.append(cuda_ms(kernel_run, 0, 1) / 1e3)
        plain_s.append(cuda_ms(plain_run, 0, 1) / 1e3)
    render_s = statistics.median(kernel_s)
    # 2 (B + 1) walk segments and 20 strategies a path (benchmarks/run.py)
    flat = n_paths * (2 * (cfg.max_bounces + 1) + 20)
    issued = rays["rays_closest"] + rays["rays_shadow"]
    emit("bdpt_render", config="caustic 128x128 8spp 4 bounces (config 4)",
         launches=launches, mean=mean, ref_mean=BDPT_REF["mean"], **rays,
         splat_energy=float(stats["splat_energy"]),
         chunk_splat_max_rel_err=splat_err, parity=parity,
         render_s=render_s, render_s_all=kernel_s,
         flat_rays_per_s=flat / render_s, issued_rays_per_s=issued / render_s,
         plain_render_s=statistics.median(plain_s), plain_render_s_all=plain_s)

    big = cfg.with_(width=512, height=512, spp=16, chunk_size=1 << 18)
    bdpt_once("caustic 512x512 16spp 4 bounces, chunks of 2^18", scene, big,
              dict(want, fused_intersect=16 * bdpt_launches(4)))
    deep = cfg.with_(max_bounces=8)
    bdpt_once("config 4 at 8 bounces", scene, deep,
              dict(want, fused_intersect=n_chunks * bdpt_launches(8)))
    mesh = mesh_scene(subdiv=4, device="cuda")
    m_cfg = BdptConfig(width=64, height=64, spp=4, max_bounces=4)
    m_chunks = -(-64 * 64 * 4 // m_cfg.chunk_size)
    bdpt_once("mesh subdiv=4 64x64 4spp 4 bounces", mesh, m_cfg,
              dict(want, fused_intersect=0,
                   traverse=m_chunks * bdpt_launches(4)))
    return launches["fused_intersect"], img


class _Stop(Exception):
    pass


def phase_progressive(bdpt_img):
    """Progressive BDPT with a checkpoint, stopped after two passes and
    resumed, against the single-shot image; progressive PT against
    render."""
    import tempfile

    from tputracer_torch.api import (render, render_bdpt_progressive,
                                     render_progressive)
    from tputracer_torch.config import BdptConfig, RenderConfig
    from tputracer_torch.scene import cornell_box

    scene = cornell_box("caustic", device="cuda")
    cfg = BdptConfig(**BDPT_CFG)
    passes = []

    def stop_after_two(done, _):
        passes.append(done)
        if len(passes) == 2:
            raise _Stop

    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "film.npz")
        try:
            render_bdpt_progressive(scene, cfg, spp_per_pass=2,
                                    checkpoint_path=ck,
                                    callback=stop_after_two)
        except _Stop:
            pass
        check(passes == [2, 4], f"progressive passes {passes}")
        with np.load(ck) as z:
            check(int(z["spp_done"]) == 4, "checkpoint after two passes")
        img, done = render_bdpt_progressive(scene, cfg, spp_per_pass=2,
                                            checkpoint_path=ck)
    ref = bdpt_img.cpu().numpy()
    check(done == cfg.spp, f"resumed progressive did {done} spp")
    bdpt_err = float((np.abs(img - ref) / (1e-7 + 1e-4 * np.abs(ref))).max())
    check(np.allclose(img, ref, rtol=1e-4, atol=1e-7),
          f"progressive bdpt differs from the single shot ({bdpt_err} of "
          f"the tolerance)")

    boxes = cornell_box("boxes", device="cuda")
    pt_cfg = RenderConfig(width=64, height=64, spp=4, max_bounces=4)
    pt_img, pt_done = render_progressive(boxes, pt_cfg, spp_per_pass=1)
    pt_ref = render(boxes, pt_cfg)[0].cpu().numpy()
    check(pt_done == 4 and np.allclose(pt_img, pt_ref, rtol=1e-5, atol=1e-7),
          "progressive pt differs from the single shot")
    emit("progressive", bdpt_passes=passes, bdpt_spp=done,
         bdpt_err_over_tol=bdpt_err,
         pt_max_abs_err=float(np.abs(pt_img - pt_ref).max()))


def fit_start(scene):
    """Config 5's starting tables: albedo x 0.5, emission x 2."""
    return {"mat_albedo": scene.mat_albedo * 0.5,
            "mat_emission": scene.mat_emission * 2.0}


def hooked_grads(scene, params, target, cfg, isect=None, occl=None):
    """api.grad_render's loss and gradients, through render_pt's
    intersection hooks (None: accel.intersect / accel.occluded)."""
    from tputracer_torch.api import _loss_and_grads
    from tputracer_torch.integrators.pt import render_pt

    p = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    render = functools.partial(render_pt, intersect_fn=isect,
                               occluded_fn=occl)
    return _loss_and_grads(render, scene, p, target, cfg)


def grads_equal(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


def grads_rel_err(a, b):
    """The largest |a - b| of a table over the largest |b| of that table."""
    return max(float((a[k].cpu() - b[k].cpu()).abs().max()
                     / b[k].abs().max().clamp(min=1e-30)) for k in a)


def counted(fn, want, what):
    """fn() with the launch counters set to 0 just before it, which must
    launch the kernels ``want`` times; returns (fn's result, counts)."""
    zero_counts()
    out = fn()
    torch.cuda.synchronize()
    launches = launch_counts()
    check(launches == want, f"{what}: launched {launches}, want {want}")
    return out, launches


def wall_s(fn, reps):
    """Seconds of each of ``reps`` calls of fn, each between
    torch.cuda.synchronize() calls."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def phase_fit():
    """The config-5 path: tputracer_torch.fit.fit of Cornell boxes at
    128x128, 4 spp, 3 bounces, counted (7 intersection launches a step, 14
    with remat, and 8 sampler launches); the gradients' bits across repeated calls; the plain
    hooks' loss and gradients; the CPU's at 32x32; remat against none;
    a resume against the uninterrupted fit; chains timed with and without
    remat; a BDPT fit; a clustered mesh through the traversal kernel; and
    peak memory at 2^20 paths with and without remat."""
    import tempfile

    from tputracer_torch import fit as tfit
    from tputracer_torch.accel import intersect_plain, occluded_plain
    from tputracer_torch.api import grad_render
    from tputracer_torch.config import BdptConfig, RenderConfig
    from tputracer_torch.integrators.bdpt import render_bdpt
    from tputracer_torch.integrators.pt import render_pt
    from tputracer_torch.scene import cornell_box, mesh_scene

    scene = cornell_box("boxes", device="cuda")
    cfg = RenderConfig(**FIT_CFG)
    paths = cfg.width * cfg.height * cfg.spp
    # closest-hit calls on bounces 0..B and shadow calls on 0..B-1, a chunk
    n_chunks = -(-paths // cfg.chunk_size)
    per_step = n_chunks * (2 * cfg.max_bounces + 1)
    none = dict(fused_intersect=0, traverse=0, pair_expand=0, pair_test=0)
    with torch.no_grad():
        target, _ = render_pt(scene, cfg)
    init = fit_start(scene)
    steps = 3 * FIT_K
    kw = dict(cfg=cfg, learning_rate=FIT_LR, init=init, log_every=0,
              steps_per_dispatch=FIT_K, checkpoint_every=FIT_K)

    # the sampler's draws a chunk: the camera, light and BSDF at every
    # bounce but the last, Russian roulette from rr_start on
    draws = n_chunks * (1 + 2 * cfg.max_bounces
                        + max(0, cfg.max_bounces - cfg.rr_start))
    with tempfile.TemporaryDirectory() as tmp:
        # the main path, counted: exactly this one call to fit
        sampler_before = sampler_launches()
        (_, p_full, h_full), launches = counted(
            lambda: tfit.fit(scene, target, steps=steps,
                             checkpoint_path=os.path.join(tmp, "full.npz"),
                             **kw),
            dict(none, fused_intersect=steps * per_step), "config-5 fit")
        sampler_step = (sampler_launches() - sampler_before) / steps
        check(sampler_step == draws, f"config-5 fit: {sampler_step} sampler "
                                     f"launches a step, want {draws}")
        losses = [h["loss"] for h in h_full]
        check(len(losses) == steps and bool(np.isfinite(losses).all()),
              f"config-5 fit losses {losses}")
        check(losses[-1] < losses[0], f"config-5 fit: the loss did not fall "
                                      f"({losses[0]} -> {losses[-1]})")
        (_, _, h_remat), launches_remat = counted(
            lambda: tfit.fit(scene, target, steps=FIT_K,
                             **dict(kw, cfg=cfg.with_(remat=True))),
            dict(none, fused_intersect=FIT_K * 2 * per_step),
            "config-5 fit with remat")
        check(h_remat[0]["loss"] == losses[0],
              "remat changed the first step's loss")

        # identical calls must give the same gradient bits on the card:
        # lookup.fetch's backward sums in an order fixed by the shapes
        runs = [grad_render(scene, init, target, cfg) for _ in range(3)]
        repeat_bits = all(torch.equal(r[0], runs[0][0])
                          and grads_equal(r[1], runs[0][1]) for r in runs[1:])
        repeat_err = max(grads_rel_err(r[1], runs[0][1]) for r in runs[1:])
        check(repeat_bits, f"three grad_render calls: the gradients differ "
                           f"by {repeat_err} (rel)")

        # stop after 16 steps, resume to 24
        ck = os.path.join(tmp, "stop.npz")
        tfit.fit(scene, target, steps=2 * FIT_K, checkpoint_path=ck, **kw)
        _, p_res, h_res = tfit.fit(scene, target, steps=steps,
                                   checkpoint_path=ck, **kw)
    res_losses = [h["loss"] for h in h_res]
    check([h["step"] for h in h_res] == list(range(2 * FIT_K, steps)),
          f"resumed at {h_res[0]['step']}")
    resume_bits = (res_losses == losses[2 * FIT_K:]
                   and grads_equal(p_res, p_full))
    resume_err = max(grads_rel_err(p_res, p_full),
                     float(np.max(np.abs(np.array(res_losses)
                                         / np.array(losses[2 * FIT_K:]) - 1))))
    check(resume_bits, f"resume differs from the uninterrupted fit by "
                       f"{resume_err} (rel)")

    # the plain version's hooks: the same loss bits, the gradients too
    loss_k, g_k = hooked_grads(scene, init, target, cfg)
    loss_p, g_p = hooked_grads(scene, init, target, cfg, intersect_plain,
                               occluded_plain)
    plain_err = grads_rel_err(g_k, g_p)
    check(torch.equal(loss_k, loss_p), "plain hooks: the loss differs")
    check(grads_equal(g_k, g_p),
          f"plain hooks: gradients differ by {plain_err} (rel)")

    # one fit step traced: every table lookup's backward is lookup.fetch's
    # one-hot matmul (emission and albedo at each of the B bounces, the
    # light's emission on each but the last: 4 B + 1 a chunk), and no
    # IndexBackward0 (table[idx]'s sort-based accumulate) is left
    p = {k: v.detach().clone().requires_grad_() for k, v in init.items()}
    opt = tfit._adam(list(p.values()), FIT_LR)
    tfit._fit_step_single(scene, p, target, cfg, opt)   # warm-up
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        tfit._fit_step_single(scene, p, target, cfg, opt)
        torch.cuda.synchronize()
    bwd_calls = {name: sum(e.count for e in prof.key_averages()
                           if e.key == name)
                 for name in ("IndexBackward0", "_OneHotFetchBackward")}
    check(bwd_calls == {"IndexBackward0": 0, "_OneHotFetchBackward":
                        n_chunks * (4 * cfg.max_bounces + 1)},
          f"a fit step's lookup backwards: {bwd_calls}")

    # the CPU's grad_render at 32x32: an H100 read the loss equal and the
    # gradients 9.5e-8 off (rel) through table[idx]'s backward and 6.7e-7
    # through lookup.fetch's (the card and the CPU sum its matmul in their
    # BLAS's orders), so 1e-6 and 1e-5 leave room and fail a wrong entry
    # of a small table row or a lower-precision backward
    small = cfg.with_(width=32, height=32)
    cpu_scene = cornell_box("boxes", device="cpu")
    with torch.no_grad():
        target_c, _ = render_pt(cpu_scene, small)
    loss_c, g_c = grad_render(cpu_scene, fit_start(cpu_scene), target_c, small)
    loss_g, g_g = grad_render(scene, init, target_c, small)
    cpu_loss_err = abs(float(loss_g) / float(loss_c) - 1.0)
    cpu_err = grads_rel_err(g_g, g_c)
    check(cpu_loss_err < 1e-6 and cpu_err < 1e-5,
          f"card against cpu 32x32: loss {cpu_loss_err}, grads {cpu_err} "
          f"(rel)")

    # remat against none: the loss bits, the gradients at rtol 1e-5
    (loss_r, g_r), _ = counted(
        lambda: grad_render(scene, init, target, cfg, remat=True),
        dict(none, fused_intersect=2 * per_step), "grad_render with remat")
    loss_0, g_0 = runs[0]
    check(torch.equal(loss_r, loss_0), "remat changed the loss")
    remat_err = grads_rel_err(g_r, g_0)
    check(all(torch.allclose(g_r[k], g_0[k], rtol=1e-5,
                             atol=1e-7 * float(g_0[k].abs().max()))
              for k in g_0), f"remat: gradients differ by {remat_err} (rel)")

    # chains of FIT_K steps, timed between synchronizes
    timing = {}
    for remat in (False, True):
        c = cfg.with_(remat=remat)
        p = {k: v.detach().clone().requires_grad_() for k, v in init.items()}
        opt = tfit._adam(list(p.values()), FIT_LR)
        tfit._fit_chain_single(scene, p, target, c, opt, 1)   # warm-up
        secs = wall_s(lambda: tfit._fit_chain_single(scene, p, target, c,
                                                     opt, FIT_K), 5)
        med = statistics.median(secs)
        timing["remat" if remat else "plain"] = {
            "chain_s_all": secs, "steps_per_s": FIT_K / med,
            # benchmarks/run.py:241-242's count: K x paths x (2B + 1)
            "fwd_bwd_rays_per_s":
                FIT_K * paths * (2 * cfg.max_bounces + 1) / med}
    emit("fit", config="boxes 128x128 4spp 3 bounces rr_start=2 (config 5)",
         steps=steps, launches=launches,
         launches_fit_step=launches["fused_intersect"] / steps,
         launches_fit_step_remat=launches_remat["fused_intersect"] / FIT_K,
         sampler_launches_fit_step=sampler_step,
         losses=losses, remat_losses=[h["loss"] for h in h_remat],
         fitted={k: v.cpu().tolist() for k, v in p_full.items()},
         grad_repeat_bitwise=repeat_bits, grad_repeat_max_rel_err=repeat_err,
         resume_bitwise=resume_bits, resume_max_rel_err=resume_err,
         plain_grads_max_rel_err=plain_err,
         fit_step_backward_calls=bwd_calls,
         cpu_32x32_loss_rel_err=cpu_loss_err, cpu_32x32_grads_rel_err=cpu_err,
         remat_grads_max_rel_err=remat_err, **timing)

    # a BDPT fit: 6 steps, 64x64 4 spp 3 bounces, one chunk
    bcfg = BdptConfig(width=64, height=64, spp=4, max_bounces=3)
    with torch.no_grad():
        b_target, _ = render_bdpt(scene, bcfg)
    b_chunks = -(-bcfg.width * bcfg.height * bcfg.spp // bcfg.chunk_size)
    t0 = time.perf_counter()
    (_, _, h_b), b_launches = counted(
        lambda: tfit.fit(scene, b_target, cfg=bcfg, steps=6,
                         learning_rate=FIT_LR, init=init, log_every=0,
                         steps_per_dispatch=3, integrator="bdpt"),
        dict(none, fused_intersect=6 * b_chunks * bdpt_launches(3)),
        "bdpt fit")
    b_seconds = time.perf_counter() - t0
    b_losses = [h["loss"] for h in h_b]
    check(bool(np.isfinite(b_losses).all()) and b_losses[-1] < b_losses[0],
          f"bdpt fit losses {b_losses}")

    # a clustered mesh: gradients through the traversal kernel
    mesh = mesh_scene(subdiv=4, device="cuda")
    mcfg = cfg.with_(width=64, height=64)
    with torch.no_grad():
        m_target, _ = render_pt(mesh, mcfg)
    (m_loss, m_g), m_launches = counted(
        lambda: grad_render(mesh, fit_start(mesh), m_target, mcfg),
        dict(none, traverse=2 * mcfg.max_bounces + 1), "mesh grad_render")
    check(bool(torch.isfinite(m_loss))
          and all(bool(torch.isfinite(g).all()) for g in m_g.values())
          and float(m_g["mat_albedo"].abs().sum()) > 0.0,
          "mesh grad_render: gradients not finite or all zero")
    emit("fit_more", bdpt_fit="boxes 64x64 4spp 3 bounces, 6 steps",
         bdpt_launches=b_launches, bdpt_losses=b_losses,
         bdpt_fit_s=b_seconds, mesh="mesh_scene(subdiv=4) 64x64 4spp",
         mesh_launches=m_launches, mesh_loss=float(m_loss))

    # memory: one chunk of 2^20 paths with and without remat
    big = cfg.with_(width=256, height=256, spp=16, max_bounces=4,
                    chunk_size=1 << 20)
    with torch.no_grad():
        big_target, _ = render_pt(scene, big)
    mem = {}
    for remat in (False, True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        loss, _ = grad_render(scene, init, big_target, big, remat=remat)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        mem[remat] = {"loss": float(loss),
                      "seconds": time.perf_counter() - t0,
                      "peak_gb": peak / 1e9,
                      "peak_above_held_gb": (peak - held) / 1e9}
    check(mem[True]["peak_gb"] < mem[False]["peak_gb"],
          f"remat did not lower peak memory: {mem}")
    check(mem[True]["loss"] == mem[False]["loss"], "remat changed the loss")
    emit("fit_memory", config="boxes 256x256 16spp 4 bounces, one chunk of "
                              "2^20 paths", plain=mem[False], remat=mem[True])
    return (launches["fused_intersect"] / steps,
            launches_remat["fused_intersect"] / FIT_K, sampler_step)


def phase_spheres():
    """The config-2 path: api.render of Cornell "spheres" (a mirror and a
    glass sphere) at 256x256, 64 spp, 6 bounces, rr_start=3, in chunks of
    2^20 paths, counted: (B + 1) closest-hit and B shadow calls a chunk,
    all through the intersection kernel's sphere branch; a finite image
    with its mean in [0.15, 0.30] (phase 4's range), and the image and ray
    counts of the plain version's hooks bit for bit (hooks take the torch
    route: the plain intersector and the torch shading).
    render_s as phase 4 times it: CUDA events around render_pt, the median
    of 3 after the counted render; the plain route's render once."""
    from tputracer_torch.accel import intersect_plain, occluded_plain
    from tputracer_torch.api import render
    from tputracer_torch.config import RenderConfig
    from tputracer_torch.integrators.pt import render_pt
    from tputracer_torch.scene import cornell_box

    scene = cornell_box("spheres", device="cuda")
    cfg = RenderConfig(**SPHERES_CFG)
    n_paths = cfg.width * cfg.height * cfg.spp
    want = -(-n_paths // cfg.chunk_size) * (2 * cfg.max_bounces + 1)
    none = dict(fused_intersect=0, traverse=0, pair_expand=0, pair_test=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path, counted: exactly this one call to render
    (img, stats), launches = counted(
        lambda: render(scene, cfg, device="cuda"),
        dict(none, fused_intersect=want), "config-2 render")
    peak = torch.cuda.max_memory_allocated()
    check(tuple(img.shape) == (cfg.height, cfg.width, 3),
          f"config-2 image shape {tuple(img.shape)}")
    check(bool(torch.isfinite(img).all()), "config-2 image not finite")
    mean = float(img.mean())
    check(0.15 <= mean <= 0.30, f"config-2 image mean {mean} outside "
                                f"[0.15, 0.30]")
    t0 = time.perf_counter()
    img_p, stats_p = render_pt(scene, cfg, intersect_fn=intersect_plain,
                               occluded_fn=occluded_plain)
    torch.cuda.synchronize()
    plain_route_render_s = time.perf_counter() - t0
    check(torch.equal(img, img_p), "config 2: the kernel's image is not the "
                                   "plain version's, bit for bit")
    check(all(torch.equal(stats[k], stats_p[k]) for k in stats),
          "config 2: the ray counts differ from the plain version's")
    kernel_s = [cuda_ms(lambda: render_pt(scene, cfg), 0, 1) / 1e3
                for _ in range(3)]
    render_s = statistics.median(kernel_s)
    issued = float(stats["rays_closest"].sum() + stats["rays_shadow"].sum())
    emit("spheres", config="spheres 256x256 64spp 6 bounces rr_start=3 "
                           "(config 2)",
         launches=launches, mean=mean, render_s=render_s,
         render_s_all=kernel_s,
         flat_rays_per_s=n_paths * (2 * cfg.max_bounces + 1) / render_s,
         issued_rays=issued, issued_rays_per_s=issued / render_s,
         plain_route_render_s=plain_route_render_s, peak_mem_gb=peak / 1e9)
    return launches["fused_intersect"]


# ---- phase 15: distribution -------------------------------------------------

# a spawned world's ranks are killed when it has run this long; the same
# bounds every collective in it
DIST_TIMEOUT_S = 300
# the JAX capacity test's scene (tests/distributed/test_tiling_capacity.py):
# mesh_scene(subdiv=8, leaf_size=128), 1,638,410 triangles, more clusters
# than the traversal kernel stages in one block
CAP_SCENE = dict(subdiv=8, leaf_size=128)
CAP_CFG = dict(width=64, height=64, spp=1, max_bounces=2)
# DP fits: config 5, and the BDPT fit at 64x64
FIT_BDPT_CFG = dict(width=64, height=64, spp=4, max_bounces=3)


def ring_bytes(cfg, n_shards):
    """ring_ppermute_bytes_per_device of a tiled PT render: each call
    sends its carry once a hop, P hops, 56 bytes a ray for a closest hit
    and 32 for a shadow ray, every lane of every chunk."""
    n_loc = cfg.width * cfg.height * cfg.spp // n_shards
    chunk = min(cfg.chunk_size, n_loc)
    calls = (cfg.max_bounces + 1) * 56 + cfg.max_bounces * 32
    return (n_loc // chunk) * calls * chunk * (n_shards if n_shards > 1
                                               else 0)


def run_world(task, world, tmp, backend):
    """Run ``world`` ranks of dist_rank(task) on this card (fresh
    interpreters, never a fork of this process) and return their result
    dicts.  task: "module.function" of a function (mesh, refs) -> a JSON
    dict, refs what ``tmp``/<task>-refs.npz holds (if it exists).  A
    rank that fails fails the phase; ranks still running after
    DIST_TIMEOUT_S are killed."""
    root = os.path.dirname(os.path.abspath(__file__))
    init = f"file://{tmp}/{task}-{backend}-rendezvous"
    procs = []
    for r in range(world):
        code = (f"import chip_smoke; chip_smoke.dist_rank({task!r}, {world},"
                f" {r}, {init!r}, {tmp!r}, {backend!r})")
        procs.append(subprocess.Popen([sys.executable, "-c", code], cwd=root,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    deadline = time.monotonic() + DIST_TIMEOUT_S
    fails = []
    try:
        for r, p in enumerate(procs):
            try:
                _, err = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                _, err = p.communicate()
                err += f"\nkilled after {DIST_TIMEOUT_S} s"
            if p.returncode != 0:
                fails.append(f"rank {r} (exit {p.returncode}): {err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    check(not fails, f"{task} world of {world} on {backend} failed:\n"
                     + "\n".join(fails))
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"{task}-{backend}-rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def dist_rank(task, world, rank, init, tmp, backend):
    """One rank of a world of run_world: joins it, runs ``task`` against
    the references the parent saved in ``tmp``, writes its results as
    JSON.  Any failed check raises, and the process exits non-zero."""
    import importlib

    from tputracer_torch.dist import launch, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if backend == "nccl":
        torch.cuda.set_device(rank)
    module, fn = task.rsplit(".", 1)
    fn = getattr(importlib.import_module(module), fn)
    refs = {}
    path = os.path.join(tmp, f"{task}-refs.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            refs = dict(z)
    launch.initialize(init, world, rank, backend=backend,
                      timeout_s=DIST_TIMEOUT_S)
    try:
        res = fn(make_mesh(), refs)
    finally:
        launch.shutdown()
    with open(os.path.join(tmp, f"{task}-{backend}-rank{rank}.json"),
              "w") as f:
        json.dump(res, f)


def _barrier_s(fn, reps):
    """Seconds of each of ``reps`` calls of fn on every rank, each from a
    barrier to the card's synchronize after it."""
    import torch.distributed as dist

    out = []
    for _ in range(reps):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def record_hops(mesh, tile, cfg):
    """Trace the first chunk of this rank's rows through the ring, with
    the traversal kernel's wrapper recording each hop's inputs; returns
    the recorded calls (each the args of traverse and its any_hit)."""
    from tputracer_torch.accel import traverse_cuda as tc
    from tputracer_torch.dist.mesh import shard_uids
    from tputracer_torch.dist.scene_shard import make_ring_backends
    from tputracer_torch.integrators.pt import trace_radiance

    calls = []
    walk = tc.traverse

    def recording(*args, leaf, any_hit=False):
        calls.append((tuple(a.clone() for a in args[:6]), args[6:], leaf,
                      any_hit))
        return walk(*args, leaf=leaf, any_hit=any_hit)

    isect, occl = make_ring_backends(mesh)
    tc.traverse = recording
    try:
        trace_radiance(tile, shard_uids(cfg, mesh, "cuda")[:cfg.chunk_size],
                       cfg, intersect_fn=isect, occluded_fn=occl)
    finally:
        tc.traverse = walk
    return calls


def hold_hop(call):
    """The traversal kernel on one recorded hop against the clustered
    walk on the same inputs: t and prim bit for bit (any hit: the
    occlusion verdicts)."""
    from tputracer_torch.accel import traverse_cuda as tc
    from tputracer_torch.accel.clustered import _traverse

    rays, tables, leaf, any_hit = call
    t_k, p_k = tc.traverse_cuda(*rays, *tables, leaf=leaf, any_hit=any_hit)
    t_p, p_p = _traverse(*rays, *tables, leaf=leaf, any_hit=any_hit)
    torch.cuda.synchronize()
    tmax, bt0 = rays[3], rays[4]
    live = tmax > rays[2]
    if any_hit:
        ok = torch.equal(t_k < tmax, t_p < tmax)
    else:
        ok = torch.equal(t_k, t_p) and torch.equal(p_k, p_p)
    return {"any_hit": any_hit, "rays": len(tmax),
            "live": int(live.sum()),
            "carried": int((live & (bt0 < tmax)).sum()),
            "improved": int((p_k >= 0).sum()), "bitwise": bool(ok)}


def rank_p2(mesh, refs):
    """Configs 1 (DP), 3 (tiled, and the traversal kernel on a hop), 4
    (DP BDPT and the BDPT ring) and 5 (DP fits) on this rank."""
    import torch.distributed as dist

    from tputracer_torch import fit as tfit
    from tputracer_torch.config import BdptConfig, RenderConfig
    from tputracer_torch.dist import (fit_step_bdpt_sharded, fit_step_sharded,
                                      render_bdpt_ring, render_bdpt_sharded,
                                      render_sharded, render_tiled)
    from tputracer_torch.dist.mesh import shard_uids
    from tputracer_torch.dist.scene_shard import (_tile, geometry_bytes,
                                                  make_ring_backends)
    from tputracer_torch.integrators.bdpt import trace_bdpt_rows
    from tputracer_torch.integrators.pt import trace_chunked
    from tputracer_torch.scene import cornell_box, mesh_scene

    P, rank = mesh.size, mesh.rank
    none = dict(fused_intersect=0, traverse=0, pair_expand=0, pair_test=0)
    res = {"rank": rank, "world": P}

    # config 1, DP
    boxes = cornell_box("boxes", device="cuda")
    cfg1 = RenderConfig(width=512, height=512, spp=16, max_bounces=4)
    per_rank = -(-cfg1.width * cfg1.height * cfg1.spp // P
                 // cfg1.chunk_size) * (2 * cfg1.max_bounces + 1)
    (img, _), launches = counted(lambda: render_sharded(boxes, cfg1, mesh),
                                 dict(none, fused_intersect=per_rank),
                                 "config-1 DP render")
    check(np.array_equal(img.cpu().numpy(), refs["config1"]),
          "config-1 DP render: not the single card's bits")
    secs = _barrier_s(lambda: render_sharded(boxes, cfg1, mesh), 3)
    res["config1"] = {"launches": launches, "bitwise": True,
                      "render_s": statistics.median(secs),
                      "render_s_all": secs}

    # config 3, geometry tiled: the scene built on the host, its tile sent
    mesh_host = mesh_scene(subdiv=6, device="cpu")
    cfg3 = RenderConfig(**MESH_CFG)
    per_rank = (cfg3.width * cfg3.height * cfg3.spp // P // cfg3.chunk_size
                * (2 * cfg3.max_bounces + 1) * P)
    (img, stats), launches = counted(
        lambda: render_tiled(mesh_host, cfg3, mesh, device="cuda"),
        dict(none, traverse=per_rank), "config-3 tiled render")
    img = img.cpu().numpy()
    for k in ("rays_closest", "rays_shadow"):
        check(np.array_equal(stats[k].cpu().numpy(), refs[f"config3_{k}"]),
              f"config-3 tiled render: {k} differ from the single card's")
    sent = float(stats["ring_ppermute_bytes_per_device"])
    check(sent == ring_bytes(cfg3, P),
          f"config-3 tiled: {sent} ring bytes, want {ring_bytes(cfg3, P)}")
    err = np.abs(img - refs["config3"])
    check(bool((err <= 2e-6 + 2e-5 * np.abs(refs["config3"])).all()),
          f"config-3 tiled render: max abs err {err.max()}")
    secs = _barrier_s(lambda: render_tiled(mesh_host, cfg3, mesh,
                                           device="cuda"), 3)
    # once more with each hop timed between synchronizes
    tile = _tile(mesh_host, mesh, "cuda")
    hops = []
    isect, occl = make_ring_backends(mesh, hop_log=hops)
    uids = shard_uids(cfg3, mesh, "cuda")
    hop_secs = _barrier_s(lambda: trace_chunked(tile, uids, cfg3,
                                                intersect_fn=isect,
                                                occluded_fn=occl), 1)
    calls = record_hops(mesh, tile, cfg3)
    check(len(calls) == (2 * cfg3.max_bounces + 1) * P,
          f"recorded {len(calls)} hops")
    # the second hop of bounce 1's closest-hit and shadow calls: rays of
    # the other rank, carrying its best hit into this rank's clusters
    hop = [hold_hop(calls[2 * P + 1]), hold_hop(calls[3 * P + 1])]
    check(all(h["bitwise"] for h in hop), f"kernel on a ring hop: {hop}")
    res["config3"] = {
        "launches": launches, "max_abs_err": float(err.max()),
        "bitwise": bool((err == 0).all()), "ring_bytes": sent,
        "tile_clusters": tile.n_clusters,
        "tile_geometry_bytes": geometry_bytes(tile),
        "render_s": statistics.median(secs), "render_s_all": secs,
        "render_s_hops_timed": hop_secs[0], "hop_s": sum(hops),
        "hops": len(hops), "hop_s_median": statistics.median(hops),
        "kernel_on_hop": hop}

    # config 4, BDPT: DP, then the ring
    caustic = cornell_box("caustic", device="cuda")
    cfg4 = BdptConfig(**BDPT_CFG)
    n_loc = cfg4.width * cfg4.height * cfg4.spp // P
    per_rank = n_loc // cfg4.chunk_size * bdpt_launches(cfg4.max_bounces)
    img, launches = counted(lambda: render_bdpt_sharded(caustic, cfg4, mesh),
                            dict(none, fused_intersect=per_rank),
                            "config-4 DP BDPT render")
    img = img.cpu().numpy()
    rel = float(np.max(np.abs(img - refs["config4"])
                       / (1e-6 + np.abs(refs["config4"]))))
    check(np.allclose(img, refs["config4"], rtol=1e-4, atol=1e-6),
          f"config-4 DP BDPT: rel err {rel}")
    L_own, _, _ = trace_bdpt_rows(caustic, shard_uids(cfg4, mesh, "cuda"),
                                  cfg4)
    check(np.array_equal(L_own.cpu().numpy(),
                         refs["config4_L_own"][rank * n_loc:
                                               (rank + 1) * n_loc]),
          "config-4 DP BDPT: L_own is not the single card's")
    secs = _barrier_s(lambda: render_bdpt_sharded(caustic, cfg4, mesh), 3)
    b = cfg4.max_bounces
    ring_want = 2 * (b + 1) + (b + 1) + P * b * (b + 1) // 2
    ring, ring_launches = counted(
        lambda: render_bdpt_ring(caustic, cfg4, mesh),
        dict(none, fused_intersect=ring_want), "config-4 BDPT ring")
    ring = ring.cpu().numpy()
    check(np.allclose(ring, refs["config4_ring"], rtol=1e-4, atol=1e-6),
          "config-4 BDPT ring: not the emulation's image")
    ring_secs = _barrier_s(lambda: render_bdpt_ring(caustic, cfg4, mesh), 1)
    res["config4"] = {"launches": launches, "L_own_bitwise": True,
                      "max_rel_err": rel, "render_s": statistics.median(secs),
                      "render_s_all": secs, "ring_launches": ring_launches,
                      "ring_max_abs_err": float(np.abs(
                          ring - refs["config4_ring"]).max()),
                      "ring_render_s": ring_secs[0]}

    # config 5, DP fits
    cfg5 = RenderConfig(**FIT_CFG)
    target = torch.from_numpy(refs["config5_target"]).cuda()
    init = fit_start(boxes)
    (loss, grads), launches = counted(
        lambda: fit_step_sharded(boxes, init, target, cfg5, mesh),
        dict(none, fused_intersect=2 * cfg5.max_bounces + 1),
        "config-5 DP fit step")
    ref_g = {k: torch.from_numpy(refs[f"config5_grad_{k}"]) for k in init}
    g_err = grads_rel_err(grads, ref_g)
    l_err = abs(float(loss) / float(refs["config5_loss"]) - 1.0)
    check(g_err < 1e-5 and l_err < 1e-5,
          f"config-5 DP step: loss {l_err}, gradients {g_err} (rel)")
    def dp_fit():
        return tfit.fit(boxes, target, cfg=cfg5, steps=FIT_K,
                        learning_rate=FIT_LR, init=init, log_every=0,
                        steps_per_dispatch=FIT_K, mesh=mesh)

    dist.barrier()
    t0 = time.perf_counter()
    (_, _, hist), fit_launches = counted(
        dp_fit, dict(none, fused_intersect=FIT_K * (2 * cfg5.max_bounces + 1)),
        "config-5 DP fit")
    first_fit_s = time.perf_counter() - t0
    # timed on a second call: here a rank's first call has taken ~8.7 s
    # for 8 steps on an H100 and its second ~1.3 s (PERF.md section 7)
    fit_s = _barrier_s(dp_fit, 1)[0]
    losses = [h["loss"] for h in hist]
    check(losses[-1] < losses[0], f"config-5 DP fit losses {losses}")
    bcfg = BdptConfig(**FIT_BDPT_CFG)
    b_target = torch.from_numpy(refs["bdpt_fit_target"]).cuda()
    b_loss, b_grads = fit_step_bdpt_sharded(boxes, init, b_target, bcfg, mesh)
    ref_b = {k: torch.from_numpy(refs[f"bdpt_fit_grad_{k}"]) for k in init}
    b_err = grads_rel_err(b_grads, ref_b)
    b_l_err = abs(float(b_loss) / float(refs["bdpt_fit_loss"]) - 1.0)
    check(b_err < 1e-5 and b_l_err < 1e-5,
          f"DP BDPT fit step: loss {b_l_err}, gradients {b_err} (rel)")
    res["config5"] = {"launches_step": launches, "loss_rel_err": l_err,
                      "grads_rel_err": g_err, "losses": losses,
                      "fit_launches": fit_launches,
                      "first_fit_s": first_fit_s,
                      "steps_per_s": FIT_K / fit_s,
                      "bdpt_loss_rel_err": b_l_err,
                      "bdpt_grads_rel_err": b_err}
    return res


def rank_capacity(mesh, refs):
    """The capacity scene, built on the host, its tile on the card,
    rendered through the ring."""
    from tputracer_torch.config import RenderConfig
    from tputracer_torch.dist import render_tiled
    from tputracer_torch.dist.scene_shard import (_tile, geometry_bytes,
                                                  pad_scene_clusters)
    from tputracer_torch.scene import mesh_scene

    t0 = time.perf_counter()
    scene = mesh_scene(device="cpu", **CAP_SCENE)
    build_s = time.perf_counter() - t0
    cfg = RenderConfig(**CAP_CFG)
    tile = _tile(scene, mesh, "cuda")
    whole = geometry_bytes(pad_scene_clusters(scene, mesh.size))
    check(geometry_bytes(tile) * mesh.size <= whole,
          "a tile holds more than its share of the geometry")
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    img, stats = render_tiled(scene, cfg, mesh, device="cuda")
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    launches = launch_counts()
    calls = 2 * cfg.max_bounces + 1
    check(launches["traverse"] == calls * mesh.size
          and launches["fused_intersect"] == 0,
          f"capacity render launched {launches}")
    img = img.cpu().numpy()
    err = np.abs(img - refs["image"])
    check(bool((err <= 2e-6 + 2e-5 * np.abs(refs["image"])).all()),
          f"capacity render: max abs err {err.max()} against the plain walk")
    return {"rank": mesh.rank, "build_s": build_s,
            "tile_clusters": tile.n_clusters,
            "tile_geometry_bytes": geometry_bytes(tile),
            "whole_geometry_bytes": whole, "launches": launches,
            "render_s_once": render_s, "max_abs_err": float(err.max()),
            "ring_bytes": float(stats["ring_ppermute_bytes_per_device"]),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def phase_dist(c1_img, c3_img, c3_stats, c4_img):
    """Phase 15: the world of one on NCCL in this process; then worlds of
    2 ranks on gloo sharing the card (and on NCCL, a card a rank, where
    there are 2 cards); then the capacity scene at 4 ranks."""
    import tempfile

    from tputracer_torch.accel import intersect_clustered, occluded_clustered
    from tputracer_torch.accel import traverse_cuda as tc
    from tputracer_torch.accel.clustered import _traverse, traverse_args
    from tputracer_torch.api import _loss_and_grads, grad_render
    from tputracer_torch.config import BdptConfig, RenderConfig
    from tputracer_torch.dist import (launch, make_mesh, render_sharded,
                                      render_tiled)
    from tputracer_torch.dist.bdpt_ring import emulate_ring_bdpt
    from tputracer_torch.integrators.bdpt import render_bdpt, trace_bdpt_rows
    from tputracer_torch.integrators.pt import film_from_radiance, render_pt
    from tputracer_torch.scene import cornell_box, mesh_scene

    none = dict(fused_intersect=0, traverse=0, pair_expand=0, pair_test=0)
    boxes = cornell_box("boxes", device="cuda")
    caustic = cornell_box("caustic", device="cuda")
    cfg1 = RenderConfig(width=512, height=512, spp=16, max_bounces=4)
    cfg3 = RenderConfig(**MESH_CFG)
    cfg4 = BdptConfig(**BDPT_CFG)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # a world of one on NCCL, in this process
        launch.initialize(f"file://{tmp}/one", 1, 0, backend="nccl")
        try:
            mesh1 = make_mesh()
            (img, _), l1 = counted(lambda: render_sharded(boxes, cfg1, mesh1),
                                   dict(none, fused_intersect=36),
                                   "NCCL world of one, config 1")
            check(np.array_equal(img.cpu().numpy(), c1_img),
                  "NCCL world of one, config 1: not phase 4's bits")
            mesh_host = mesh_scene(subdiv=6, device="cpu")
            (img, stats), l3 = counted(
                lambda: render_tiled(mesh_host, cfg3, mesh1, device="cuda"),
                dict(none, traverse=68), "NCCL world of one, config 3 tiled")
            img = img.cpu().numpy()
            for k in ("rays_closest", "rays_shadow"):
                check(np.array_equal(stats[k].cpu().numpy(), c3_stats[k]),
                      f"NCCL world of one, config 3: {k} not phase 7's")
            check(float(stats["ring_ppermute_bytes_per_device"]) == 0.0,
                  "a world of one sent ring bytes")
            # one tile is the whole scene: the ring's hits, normalized as
            # finalize_hit does, are the replicated walk's bit for bit
            check(np.array_equal(img, c3_img),
                  "NCCL world of one, config 3 tiled: not phase 7's bits")
            out["one_nccl"] = {"config1_launches": l1, "config1_bitwise": True,
                               "config3_launches": l3,
                               "config3_bitwise": True}
        finally:
            launch.shutdown()

        # the single card's references of the 2-rank worlds
        cfg5 = RenderConfig(**FIT_CFG)
        with torch.no_grad():
            target5, _ = render_pt(boxes, cfg5)
        loss5, g5 = grad_render(boxes, fit_start(boxes), target5, cfg5)
        bcfg = BdptConfig(**FIT_BDPT_CFG)
        with torch.no_grad():
            b_target, _ = render_bdpt(boxes, bcfg)
        p = {k: v.detach().clone().requires_grad_()
             for k, v in fit_start(boxes).items()}
        b_loss, b_g = _loss_and_grads(render_bdpt, boxes, p, b_target, bcfg)
        n4 = cfg4.width * cfg4.height * cfg4.spp
        uids4 = torch.arange(n4, dtype=torch.int64, device="cuda")
        L_own, _, _ = trace_bdpt_rows(caustic, uids4, cfg4)
        L_ring, splat = emulate_ring_bdpt(caustic, uids4, cfg4, 2)
        ring_img = film_from_radiance(L_ring, cfg4) + torch.flip(
            (splat / float(n4)).reshape(cfg4.height, cfg4.width, 3), (0,))
        refs = {"config1": c1_img, "config3": c3_img,
                "config4": c4_img, "config4_L_own": L_own.cpu().numpy(),
                "config4_ring": ring_img.cpu().numpy(),
                "config5_target": target5.cpu().numpy(),
                "config5_loss": loss5.cpu().numpy(),
                "bdpt_fit_target": b_target.cpu().numpy(),
                "bdpt_fit_loss": b_loss.cpu().numpy()}
        refs.update({f"config3_{k}": v for k, v in c3_stats.items()})
        refs.update({f"config5_grad_{k}": v.cpu().numpy()
                     for k, v in g5.items()})
        refs.update({f"bdpt_fit_grad_{k}": v.cpu().numpy()
                     for k, v in b_g.items()})
        np.savez(os.path.join(tmp, "chip_smoke.rank_p2-refs.npz"), **refs)
        del L_own, L_ring, splat

        t0 = time.perf_counter()
        out["p2_gloo"] = run_world("chip_smoke.rank_p2", 2, tmp, "gloo")
        out["p2_gloo_world_s"] = time.perf_counter() - t0
        if torch.cuda.device_count() >= 2:
            # a card a rank: the speed-up over this card alone, the single
            # card's and rank 0's wall times; efficiency = T1 / (2 T2)
            nccl = run_world("chip_smoke.rank_p2", 2, tmp, "nccl")
            mesh_card = mesh_host.to("cuda")
            one = {"config1": lambda: render_pt(boxes, cfg1),
                   "config3": lambda: render_pt(mesh_card, cfg3),
                   "config4": lambda: render_bdpt(caustic, cfg4)}
            out["p2_nccl"] = nccl
            out["scaling_efficiency"] = {
                k: statistics.median(wall_s(fn, 3))
                / (2 * nccl[0][k]["render_s"]) for k, fn in one.items()}

        # the capacity scene: more clusters than the flat scan stages, so
        # one launch takes the tree walk, which must give the plain walk's
        # bits
        t0 = time.perf_counter()
        cap = mesh_scene(device="cpu", **CAP_SCENE)
        cap_build_s = time.perf_counter() - t0
        max_clusters = tc.LIB.limit("tpt_traverse_max_clusters")
        check(cap.n_clusters > max_clusters,
              f"capacity scene: {cap.n_clusters} clusters, the flat scan "
              f"stages {max_clusters}")
        cap_card = cap.to("cuda")
        n = 1024
        o = torch.full((n, 3), 0.5, device="cuda")
        d = torch.nn.functional.normalize(torch.randn(n, 3, device="cuda"),
                                          dim=1)
        zero, far = torch.zeros(n, device="cuda"), torch.full(
            (n,), BIG, device="cuda")
        walk_in = (o, d, zero, far, far,
                   torch.full((n,), -1, dtype=torch.int32, device="cuda"))
        t_k, p_k = tc.traverse_cuda(*walk_in, *traverse_args(cap_card),
                                    leaf=cap.leaf_size)
        t_p, p_p = _traverse(*walk_in, *traverse_args(cap_card),
                             leaf=cap.leaf_size)
        check(torch.equal(t_k, t_p) and torch.equal(p_k, p_p),
              "the tree walk on the capacity scene differs from the plain "
              "walk")
        cap_cfg = RenderConfig(**CAP_CFG)
        t0 = time.perf_counter()
        cap_img, _ = render_pt(cap_card, cap_cfg,
                               intersect_fn=intersect_clustered,
                               occluded_fn=occluded_clustered)
        cap_img = cap_img.cpu().numpy()
        plain_s = time.perf_counter() - t0
        del cap_card
        torch.cuda.empty_cache()
        np.savez(os.path.join(tmp, "chip_smoke.rank_capacity-refs.npz"),
                 image=cap_img)
        t0 = time.perf_counter()
        out["capacity"] = run_world("chip_smoke.rank_capacity", 4, tmp,
                                    "gloo")
        out["capacity_world_s"] = time.perf_counter() - t0
        out["capacity_scene"] = {
            "n_tris": cap.n_tris, "n_clusters": cap.n_clusters,
            "max_clusters": max_clusters,
            "tree_walk_hits": int((p_k >= 0).sum()),
            "host_build_s": cap_build_s,
            # the plain walk's hooks take the torch shading too
            "plain_route_render_s": plain_s,
            "mean": float(cap_img.mean())}
    check(np.isfinite(out["capacity_scene"]["mean"]),
          "capacity render is not finite")
    p2 = out["p2_gloo"]
    emit("dist", **out)
    return (p2[0]["config1"]["launches"]["fused_intersect"],
            p2[0]["config3"]["launches"]["traverse"],
            p2[0]["config4"]["launches"]["fused_intersect"],
            p2[0]["config4"]["ring_launches"]["fused_intersect"],
            p2[0]["config5"]["launches_step"]["fused_intersect"])


# ---- phase 17: the compiled entry points (CUDA graphs) ----------------------


def free_graphs():
    """Drop the captured graphs and their pools between phases."""
    from tputracer_torch import graphs

    graphs.clear()


def graph_same(kind, a, b):
    """Whether the graphed result ``a`` is the eager ``b``: (ok, max rel
    err).  PT: the image and ray counts bit for bit.  BDPT: its ray counts
    bit for bit and its image within 1e-5 (rel to 1 + |b|), the splat's
    index_add_ adding in no fixed order on the card."""
    img_a, img_b = (torch.as_tensor(x[0]).detach().cpu() for x in (a, b))
    rel = float(((img_a - img_b).abs() / (1.0 + img_b.abs())).max()) \
        if img_b.numel() else 0.0
    st_a, st_b = a[1], b[1]
    if isinstance(st_b, dict):
        if kind == "bdpt":
            st_a = {k: st_a[k] for k in ("rays_closest", "rays_shadow")}
            st_b = {k: st_b[k] for k in ("rays_closest", "rays_shadow")}
        stats_ok = st_a.keys() == st_b.keys() and all(
            torch.equal(st_a[k], st_b[k]) for k in st_b)
    else:
        stats_ok = st_a == st_b
    same = rel < 1e-5 if kind == "bdpt" else torch.equal(img_a, img_b)
    return same and stats_ok, rel


def graph_paths(mesh):
    """The paths of phase 17: (name, kind, scene, cfg, graphed entry,
    eager counterpart, TPUTRACER_PAIRS, launches of one call, a scene of
    other shapes).  Each entry takes (scene, cfg)."""
    from tputracer_torch import api
    from tputracer_torch.config import BdptConfig, RenderConfig
    from tputracer_torch.integrators import bdpt
    from tputracer_torch.integrators.pt import render_pt
    from tputracer_torch.scene import cornell_box, mesh_scene

    def loop(body, spp):
        return lambda sc, cfg: api._progressive_loop(
            sc, cfg, lambda off, step: body(sc, cfg, off, step), spp, None,
            True, None)

    none = dict(fused_intersect=0, traverse=0, pair_expand=0, pair_test=0)
    boxes = cornell_box("boxes", device="cuda")
    spheres = cornell_box("spheres", device="cuda")
    caustic = cornell_box("caustic", device="cuda")
    small_mesh = mesh_scene(subdiv=4, device="cuda")
    c1 = RenderConfig(width=512, height=512, spp=16, max_bounces=4)
    c3 = RenderConfig(**MESH_CFG)
    c4 = BdptConfig(**BDPT_CFG)
    on_route = dict(none, traverse=68, pair_expand=68, pair_test=68)
    return [
        ("config 1", "pt", boxes, c1, api.render, render_pt, False,
         dict(none, fused_intersect=36), spheres),
        ("config 2", "pt", spheres, RenderConfig(**SPHERES_CFG), api.render,
         render_pt, False, dict(none, fused_intersect=52), boxes),
        ("config 3", "pt", mesh, c3, api.render, render_pt, False,
         dict(none, traverse=68), small_mesh),
        ("config 3, pair route", "pt", mesh, c3, api.render, render_pt, True,
         on_route, small_mesh),
        ("config 4", "bdpt", caustic, c4, api.render_bdpt, bdpt.render_bdpt,
         False, dict(none, fused_intersect=100), boxes),
        ("config 1, progressive in passes of 4", "pt", boxes, c1,
         lambda sc, cfg: api.render_progressive(sc, cfg, spp_per_pass=4),
         loop(api._pt_pass, 4), False, dict(none, fused_intersect=36),
         spheres),
        ("config 4, progressive in passes of 4", "bdpt", caustic, c4,
         lambda sc, cfg: api.render_bdpt_progressive(sc, cfg,
                                                     spp_per_pass=4),
         loop(api._bdpt_pass, 4), False, dict(none, fused_intersect=100),
         boxes),
    ]


def by_counter(kernels):
    """Counts by kernel (a graph's census) renamed to launch_counts'
    names; the fold kernel must run as often as the pair test."""
    check(kernels["fold_kernel"] == kernels["pairtest_kernel"],
          f"fold kernels {kernels['fold_kernel']}, pair tests "
          f"{kernels['pairtest_kernel']}")
    return {c: kernels[k] for k, c in COUNTER_OF.items()}


def traced_launches(fn, want, name, tries=3):
    """The declared kernels (by launch_counts' names) and all device
    events in torch.profiler traces of calls of
    fn, until one holds exactly ``want`` (at most ``tries``).  A trace
    may drop a kernel's record (CUPTI's buffers), never add one: every
    trace must hold at most ``want`` of each kernel, and one exactly
    ``want``.  Returns [(counts, device events)] of each trace."""
    from tputracer_torch import cuda_build, graphs

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    runs = []
    while len(runs) < tries and (not runs or runs[-1][0] != want):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        out, events = dict.fromkeys(cuda_build.kernels(), 0), 0
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                events += 1
                k = graphs.kernel_of(e.name)
                if k is not None:
                    out[k] += 1
        runs.append((by_counter(out), events))
        check(all(runs[-1][0][k] <= n for k, n in want.items()),
              f"{name}: a traced call ran {runs[-1][0]}, want {want}")
    check(runs[-1][0] == want, f"{name}: traced calls ran {runs}, want "
                               f"{want}")
    return runs


def until_captured(fn, want, name):
    """Calls of fn, each counted (it must launch the kernels ``want``
    times), until one has captured a graph (at most two: a key's first
    call runs eagerly, its second captures); returns (the capturing
    call's result, the first call's seconds, the capturing call's)."""
    from tputracer_torch import graphs

    captures, secs = graphs.CAPTURES, []
    while graphs.CAPTURES == captures and len(secs) < 2:
        t0 = time.perf_counter()
        out, _ = counted(fn, want, name)
        secs.append(time.perf_counter() - t0)
    check(graphs.CAPTURES == captures + 1,
          f"{name}: {graphs.CAPTURES - captures} captures, want 1")
    return out, secs[0], secs[-1]


def graph_case(name, kind, base, cfg, entry, eager, pairs_on, want, other):
    """One path of phase 17: the first call and the capture, counted; the
    graph's kernel nodes and a traced replay's kernels against the
    counts; the eager counterpart's bits; the two in turns, the median
    of 3; a material edited in place, then replaced, without a new
    capture; a scene of other shapes, captured anew; a table that
    requires grad, eager.  Returns the phase line's fields."""
    import dataclasses

    from tputracer_torch import graphs

    before = os.environ.get("TPUTRACER_PAIRS")
    if pairs_on:
        os.environ["TPUTRACER_PAIRS"] = "1"
    else:
        os.environ.pop("TPUTRACER_PAIRS", None)
    try:
        graphs.clear()
        # the caller's scene: its own albedo, edited in place below
        sc = dataclasses.replace(base, mat_albedo=base.mat_albedo.clone())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        captures = graphs.CAPTURES
        out, first_s, capture_call_s = until_captured(
            lambda: entry(sc, cfg), want, name)
        peak = torch.cuda.max_memory_allocated()
        g = graphs.graphs()[0]
        info = dict(g.info, **capture_seconds())
        copies, replays = graphs.COPIES, g.replays
        entry(sc, cfg)
        # a progressive render replays its pass's graph once a pass
        copies, replays = graphs.COPIES - copies, g.replays - replays
        nodes = {k: n * replays for k, n in by_counter(g.census).items()}
        check(nodes == want, f"{name}: the graph's kernel nodes {g.census} "
                             f"x {replays} replays a call, want {want}")
        traced = traced_launches(lambda: entry(sc, cfg), want, name)
        src = [x.clone() for x in g.inputs]
        copy_ms = cuda_ms(lambda: graphs.copy_in(g.scene, sc, g.inputs, src),
                          1, 5)
        ref = eager(sc, cfg)
        ok, rel = graph_same(kind, out, ref)
        check(ok, f"{name}: the capturing call's result is not the eager "
                  f"one's (rel {rel})")
        graph_s, eager_s = [], []
        for _ in range(3):   # in turns, so drift hits both alike
            graph_s.append(cuda_ms(lambda: entry(sc, cfg), 0, 1) / 1e3)
            eager_s.append(cuda_ms(lambda: eager(sc, cfg), 0, 1) / 1e3)
        ok, rel_r = graph_same(kind, entry(sc, cfg), ref)
        check(ok, f"{name}: a replay differs from the eager result "
                  f"(rel {rel_r})")

        # edits: in place, then a new tensor of the same shape
        sc.mat_albedo.mul_(0.8)
        replaced = dataclasses.replace(sc, mat_albedo=base.mat_albedo * 0.6)
        edits = []
        for edited in (sc, replaced):
            ok, rel_e = graph_same(kind, entry(edited, cfg),
                                   eager(edited, cfg))
            check(ok, f"{name}: an edited scene's graphed result differs "
                      f"from its eager one (rel {rel_e})")
            edits.append(rel_e)
        ok, _ = graph_same(kind, entry(replaced, cfg), ref)
        check(not ok, f"{name}: the edit did not change the result")
        check(graphs.CAPTURES == captures + 1,
              f"{name}: an edit captured again")

        until_captured(lambda: entry(other, cfg),
                       launch_counts_of(lambda: eager(other, cfg)), name)
        check(len(graphs.graphs()) == 2,
              f"{name}: {len(graphs.graphs())} graphs, want 2")
        pool_second = graphs.graphs()[1].info["pool_bytes"]
        grad_fn = None
        if "progressive" not in name:   # a film on the host has no graph
            # at 1 spp: eager with autograd keeps every bounce's tensors
            one = cfg.with_(spp=1)
            leaf = dataclasses.replace(
                base, mat_albedo=base.mat_albedo.clone().requires_grad_())
            with torch.enable_grad():
                img_g, st_g = entry(leaf, one)
            grad_fn = type(img_g.grad_fn).__name__
            check(img_g.grad_fn is not None,
                  f"{name}: a scene that requires grad lost its grad_fn")
            check(graphs.CAPTURES == captures + 2,
                  f"{name}: a call with grad captured a graph")
            with torch.no_grad():
                ok, _ = graph_same(kind, (img_g.detach(), st_g),
                                   eager(leaf, one))
            check(ok, f"{name}: with grad, not the eager bits")
    finally:
        if before is None:
            os.environ.pop("TPUTRACER_PAIRS", None)
        else:
            os.environ["TPUTRACER_PAIRS"] = before
        graphs.clear()
    render_s, eager_render_s = (statistics.median(graph_s),
                                statistics.median(eager_s))
    return dict(config=name, launches=want, traced_call=traced,
                replays_a_call=replays,
                first_call_s=first_s, capture_call_s=capture_call_s,
                capture_s=info["capture_s"], census_s=info["census_s"],
                instantiate_s=info["instantiate_s"],
                kernel_nodes=g.census["kernel_nodes"],
                graph_nodes=g.census["nodes"],
                pool_gb=info["pool_bytes"] / 1e9,
                pool_gb_second_graph=pool_second / 1e9,
                copies_a_call=copies, copy_in_ms=copy_ms,
                peak_mem_gb=peak / 1e9, max_rel_err=max(rel, rel_r),
                edits_max_rel_err=max(edits), grad_fn=grad_fn,
                render_s=render_s, render_s_all=graph_s,
                eager_render_s=eager_render_s, eager_render_s_all=eager_s,
                eager_over_graphed=eager_render_s / render_s)


def launch_counts_of(fn):
    """The kernels' launches in one call of fn, as the counters read."""
    zero_counts()
    fn()
    torch.cuda.synchronize()
    return launch_counts()


def bdpt_rows_bits():
    """Config 4's trace_bdpt_rows (every chunk of the render) through
    graphs.call against the eager call: L_own and the ray counts bit for
    bit, the splat within 1e-5."""
    from tputracer_torch import graphs
    from tputracer_torch.config import BdptConfig
    from tputracer_torch.integrators.bdpt import trace_bdpt_rows
    from tputracer_torch.scene import cornell_box

    sc = cornell_box("caustic", device="cuda")
    cfg = BdptConfig(**BDPT_CFG)

    def rows(s):
        uids = torch.arange(cfg.width * cfg.height * cfg.spp,
                            dtype=torch.int64, device=s.device)
        return trace_bdpt_rows(s, uids, cfg)

    chunks = cfg.width * cfg.height * cfg.spp // cfg.chunk_size
    try:
        L_e, sp_e, st_e = rows(sc)
        for _ in range(3):   # eager on the capture stream, capture, replay
            before = connect_launches(), splat_launches()
            L_g, sp_g, st_g = graphs.call("trace_bdpt_rows", rows, sc, cfg)
            torch.cuda.synchronize()
            launches = (connect_launches() - before[0],
                        splat_launches() - before[1])
            check(launches == (2 * chunks, 2 * chunks),
                  f"config 4: {launches} connection and splat launches for "
                  f"{chunks} chunks, want 2 of each a chunk")
            check(torch.equal(L_g, L_e), "config 4: the graphed L_own is "
                                         "not the eager one, bit for bit")
            check(all(torch.equal(st_g[k], st_e[k]) for k in st_e),
                  "config 4: the graphed ray counts differ")
            rel = float(((sp_g - sp_e).abs() / (1.0 + sp_e.abs())).max())
            check(rel < 1e-5, f"config 4: graphed splat off by {rel}")
    finally:
        graphs.clear()
    return rel


def phase_graphs(mesh):
    """Phase 17: each render path through its compiled entry point (a CUDA
    graph) and its eager counterpart, in turns (graph_case)."""
    start = time.perf_counter()
    results = []
    for path in graph_paths(mesh):
        res = graph_case(*path)
        emit("graphs", **res)
        results.append(res)
    splat_err = bdpt_rows_bits()
    emit("graphs", config="config 4, trace_bdpt_rows", l_own="bit for bit",
         splat_max_rel_err=splat_err,
         seconds=time.perf_counter() - start)
    return results


# the sampler's traffic: 8 bytes of uid in and three float32 out, a lane
SAMPLER_BYTES_PER_LANE = 20


def sampler_bits(n, seed):
    """The kernel against uniform3_plain, bit for bit, on n uids drawn over
    the whole int64 range, for salts and seeds at and above 2^31; one
    launch a call.  Returns the largest absolute difference seen."""
    from tputracer_torch import rng

    r = np.random.default_rng(seed)
    uid = torch.from_numpy(r.integers(-(2**63), 2**63 - 1, n, np.int64))
    uid = uid.cuda()
    draws = [(0, 0), (25, 7), (2**31 + 5, 2**32 - 1), (2**32 - 1, 2**31)]
    err = 0.0
    for salt, sd in draws:
        before = sampler_launches()
        got = rng.uniform3_cuda(uid, salt, sd)
        want = rng.uniform3_plain(uid, salt, sd)
        torch.cuda.synchronize()
        check(sampler_launches() == before + 1,
              f"sampler: {sampler_launches() - before} launches for one "
              f"call")
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"sampler: the kernel differs from uniform3_plain at n={n}, "
              f"salt={salt}, seed={sd}")
        err = max([err] + [float((g - w).abs().max())
                           for g, w in zip(got, want)])
    return err


def graph_ms(fn, reps=20):
    """Milliseconds of the card per call of fn inside one CUDA graph of
    ``reps`` calls (the median of 5 replays), as a render's graph runs
    it: no host work between the launches.  device_ms of a call whose
    host work outlasts its kernels times the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # captured on the warmed stream, whose kernel scratch the warm-up made
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, 1, 5) / reps


def sampler_times(n):
    """The kernel and the plain version on the uids of a render's chunk
    (0 .. n-1, config 1's first): one call with its host work (median of
    5), the card's time a call over 20 back to back, the same inside a
    CUDA graph, and the bound."""
    from tputracer_torch import rng

    uid = torch.arange(n, dtype=torch.int64, device="cuda")
    salt = rng.salt(1, rng.SLOT_BSDF)

    def kernel():
        rng.uniform3(uid, salt, 0)

    def plain():
        rng.uniform3_plain(uid, salt, 0)

    bound_ms, bound_by = bound(0, SAMPLER_BYTES_PER_LANE * n)
    return dict(lanes=n, ms=cuda_ms(kernel, 2, 5), device_ms=device_ms(kernel),
                graph_ms=graph_ms(kernel), bound_ms=bound_ms,
                bound_by=bound_by, plain_ms=cuda_ms(plain, 2, 5),
                plain_graph_ms=graph_ms(plain))


def sampler_render(name, sc, cfg, draws):
    """Config ``name`` through api.render, three calls (eager, capture,
    replay), then through a second graph with uniform3 on the torch route:
    the launches, draws and graph nodes of each, the bits, and the two
    graphs' replays in turns."""
    from tputracer_torch import graphs, rng, trace
    from tputracer_torch.api import render
    from tputracer_torch.integrators.pt import render_pt

    def torch_sampler(s):
        kernel_route = rng.uniform3
        rng.uniform3 = rng.uniform3_plain
        try:
            return render_pt(s, cfg)
        finally:
            rng.uniform3 = kernel_route

    graphs.clear()
    calls = []
    for _ in range(3):   # eager, the capture, a replay
        trace.reset()
        before = sampler_launches()
        out = render(sc, cfg)
        torch.cuda.synchronize()
        spans = trace.records("rng.uniform3")
        calls.append(dict(launches=sampler_launches() - before,
                          draws=len(spans),
                          through_kernel=sum(r.counts["kernel"]
                                             for r in spans)))
    check([c["launches"] for c in calls] == [draws] * 3,
          f"{name}: sampler launches {calls}, want {draws} a call")
    check([c["draws"] for c in calls[:2]] == [draws] * 2
          and all(c["through_kernel"] == c["draws"] for c in calls),
          f"{name}: draws {calls}, want {draws} through the kernel")
    g_kernel = graphs.graphs()[0]
    check(g_kernel.census["uniform3_kernel"] == draws,
          f"{name}: the graph holds {g_kernel.census['uniform3_kernel']} "
          f"sampler kernels, want {draws}")
    before = sampler_launches()
    for _ in range(3):
        plain = graphs.call("sampler_torch_route", torch_sampler, sc, cfg)
    torch.cuda.synchronize()
    check(sampler_launches() == before,
          f"{name}: the torch route launched the kernel")
    g_plain = graphs.graphs()[1]
    check(g_plain.census["uniform3_kernel"] == 0,
          f"{name}: the torch route's graph holds sampler kernels")
    check(graph_same("pt", out, plain)[0],
          f"{name}: the kernel's render is not the torch sampler's, bit for "
          f"bit")
    kernel_ms, plain_ms = [], []
    for _ in range(5):   # in turns, so drift hits both alike
        kernel_ms.append(cuda_ms(lambda: render(sc, cfg), 0, 1))
        plain_ms.append(cuda_ms(lambda: graphs.call(
            "sampler_torch_route", torch_sampler, sc, cfg), 0, 1))
    res = dict(config=name, draws=draws, calls=calls,
               kernel_nodes=g_kernel.census["kernel_nodes"],
               kernel_nodes_torch_route=g_plain.census["kernel_nodes"],
               replay_ms=statistics.median(kernel_ms),
               replay_ms_all=kernel_ms,
               replay_ms_torch_route=statistics.median(plain_ms),
               replay_ms_torch_route_all=plain_ms)
    graphs.clear()
    return res


def phase_sampler(mesh):
    """Phase 18: the sampler kernel against its plain version, timed, and
    configs 1 and 3 through it and through the torch sampler, graphed."""
    from tputracer_torch.config import RenderConfig
    from tputracer_torch.scene import cornell_box

    t0 = time.perf_counter()
    max_abs = max(sampler_bits(n, seed=n)
                  for n in (1 << 16, 1 << 20, (1 << 20) + 5))
    times = [sampler_times(n) for n in (1 << 16, 1 << 20)]
    for t in times:
        emit("sampler", **t)
    renders = [
        # the camera's draw a chunk; the PT kernels draw the rest
        sampler_render("config 1", cornell_box("boxes", device="cuda"),
                       RenderConfig(width=512, height=512, spp=16,
                                    max_bounces=4), 4),
        sampler_render("config 3", mesh, RenderConfig(**MESH_CFG), 4),
    ]
    for r in renders:
        emit("sampler", **r)
    emit("sampler", max_abs_err=max_abs, seconds=time.perf_counter() - t0)
    return times, renders, max_abs


# the bytes of each vertex field a lane (bdpt_cuda.FIELDS)
FIELD_BYTES = {"p": 12, "ng": 12, "wo": 12, "beta": 12, "pdf_fwd": 4,
               "pdf_rev": 4, "mat": 4, "valid": 1, "delta": 1}
# a strategy's bytes a lane between the two kernels: the first writes the
# shadow ray's origin and direction, tmax, the contribution and the mask
# (12 + 12 + 4 + 12 + 1); the second reads the mask, the occlusion byte
# and the contribution (1 + 1 + 12)
CONNECT_STRATEGY_BYTES = 41 + 14


def connect_bytes_per_lane(n_eye, n_light, n_verts):
    """The least bytes a lane of the two connection kernels moves: every
    vertex field each kernel reads, once a kernel (the first reads the joined
    vertices; the second the joined points, normals and materials, their
    neighbours' points and normals, and the ratio chains' pdfs and
    flags), CONNECT_STRATEGY_BYTES a strategy, and the (n, 3) sum."""
    from tputracer_torch.integrators.bdpt_cuda import strategies

    first, second = set(), set()
    pairs = strategies(n_eye, n_light, n_verts)
    for s, t in pairs:
        z, y = ("z", t - 1), ("y", s - 1)
        first |= {(z, f) for f in ("p", "ng", "wo", "beta", "mat", "valid",
                                   "delta")}
        first |= {(y, f) for f in ("p", "ng", "beta", "valid", "delta")}
        second |= {(z, f) for f in ("p", "ng", "wo", "mat")}
        second |= {(y, "p"), (y, "ng")}
        if s >= 2:
            first |= {(y, "wo"), (y, "mat")}
            second |= {(y, "wo"), (y, "mat"), (("y", s - 2), "p"),
                       (("y", s - 2), "ng")}
        if t >= 3:
            second |= {(("z", t - 2), "p"), (("z", t - 2), "ng")}
        for side, top in (("z", t - 1), ("y", s - 1)):
            for a in range(1 if side == "z" else 0, top + 1):
                second |= {((side, a), "pdf_fwd"), ((side, a), "delta")}
                if a > 0:
                    second.add(((side, a - 1), "delta"))
                if a <= top - 2:   # the two nearest come from the kernel
                    second.add(((side, a), "pdf_rev"))
    reads = sum(FIELD_BYTES[f] for fields in (first, second)
                for _, f in fields)
    return reads + CONNECT_STRATEGY_BYTES * len(pairs) + 12


def connect_bits(scene, cfg, ys, zs):
    """The kernels' route against connection_radiance_plain on these
    vertices: the radiance and the shadow-ray count bit for bit, two
    launches.  Returns the largest absolute difference."""
    from tputracer_torch.integrators import bdpt, bdpt_cuda

    got, want = {}, {}
    before = connect_launches()
    L_k = bdpt_cuda.connection_radiance_cuda(scene, cfg, ys, zs,
                                             stats_acc=got)
    L_p = bdpt.connection_radiance_plain(scene, cfg, ys, zs, stats_acc=want)
    torch.cuda.synchronize()
    check(connect_launches() == before + 2,
          f"connect: {connect_launches() - before} launches for one call")
    check(torch.equal(L_k, L_p), f"connect: the kernels differ from "
                                 f"connection_radiance_plain (power="
                                 f"{cfg.mis_power})")
    check(torch.equal(got["rays_shadow"], want["rays_shadow"]),
          "connect: the shadow-ray count differs")
    check(float(L_p.sum()) > 0.0, "connect: no radiance")
    return float((L_k - L_p).abs().max())


# a splat strategy's bytes a lane between the two kernels: the first
# writes the shadow ray's direction, tmax, the contribution, the mask and
# the pixel (12 + 4 + 12 + 1 + 4); the second reads the mask, the
# occlusion byte, the contribution and the pixel (1 + 1 + 12 + 4)
SPLAT_STRATEGY_BYTES = 33 + 18


def splat_bytes_per_lane(n_light, n_verts):
    """The least bytes a lane of the two splat kernels moves: every vertex
    field each kernel reads, once a kernel (the first reads each light
    vertex's point, normal, throughput and flags, and from s = 2 its
    direction and material; the second the MIS chains: the vertex, its
    predecessor's point and normal, and the chains' pdfs and flags),
    SPLAT_STRATEGY_BYTES a strategy and the lane's shadow-ray origin (12).
    The film's atomics, 12 bytes a surviving splat, and its zeroing come
    on top (splat_bytes)."""
    from tputracer_torch.integrators.bdpt_cuda import splat_strategies

    first, second = set(), set()
    pairs = splat_strategies(n_light, n_verts)
    for s, _ in pairs:
        y = s - 1
        first |= {(y, f) for f in ("p", "ng", "beta", "valid", "delta")}
        second |= {(y, "p"), (y, "ng")}
        if s >= 2:
            first |= {(y, "wo"), (y, "mat")}
            second |= {(y, "wo"), (y, "mat"), (y - 1, "p"), (y - 1, "ng")}
        for a in range(s):
            second |= {(a, "pdf_fwd"), (a, "delta")}
            if a > 0:
                second.add((a - 1, "delta"))
            if a <= s - 3:   # the two nearest come from the kernel
                second.add((a, "pdf_rev"))
    reads = sum(FIELD_BYTES[f] for fields in (first, second)
                for _, f in fields)
    return reads + SPLAT_STRATEGY_BYTES * len(pairs) + 12


@contextlib.contextmanager
def splat_adds():
    """The (pixel ids, values) that each index_add_ adds while the block
    runs, one pair a t1_splats_plain strategy: a masked lane's id is the
    dump row H * W and its value 0."""
    calls = []
    add = torch.Tensor.index_add_

    def spy(self, dim, index, source, *args, **kwargs):
        calls.append((index.clone(), source.clone()))
        return add(self, dim, index, source, *args, **kwargs)

    torch.Tensor.index_add_ = spy
    try:
        yield calls
    finally:
        torch.Tensor.index_add_ = add


def splat_film_bound(adds, film):
    """Per pixel, the most two sums of the same nonnegative splats in two
    orders can differ: 2 (k - 1) u times their sum for k splats (u =
    2^-24, recursive summation from 0), with 0.1% for the rounding of
    ``film`` itself."""
    n_pix = film.shape[0]
    ids = torch.cat([i for i, _ in adds])
    k = torch.bincount(ids[ids < n_pix], minlength=n_pix).to(film.dtype)
    return (2.0 * torch.clamp(k - 1.0, min=0.0) * 2.0 ** -24 * 1.001)[
        :, None] * film.abs()


def splat_bits(scene, cfg, ys, zs):
    """The splat kernels' route against t1_splats_plain on these vertices:
    the shadow-ray count bit for bit, two launches, the film within
    splat_film_bound.  Returns (the largest difference over the bound's,
    the largest absolute difference)."""
    from tputracer_torch.integrators import bdpt, bdpt_cuda

    got, want = {}, {}
    before = splat_launches()
    film_k = bdpt_cuda.t1_splats_cuda(scene, cfg, ys, zs, stats_acc=got)
    with splat_adds() as adds:
        film_p = bdpt.t1_splats_plain(scene, cfg, ys, zs, stats_acc=want)
    torch.cuda.synchronize()
    check(splat_launches() == before + 2,
          f"splat: {splat_launches() - before} launches for one call")
    check(torch.equal(got["rays_shadow"], want["rays_shadow"]),
          "splat: the shadow-ray count differs")
    check(float(film_p.sum()) > 0.0, "splat: no splats")
    diff = (film_k - film_p).abs()
    tol = splat_film_bound(adds, film_p)
    check(bool((diff <= tol).all()),
          f"splat: the film is off by {float((diff - tol).max())} past the "
          f"bound of its sums' order (power={cfg.mis_power})")
    return float((diff / torch.clamp(tol, min=1e-30)).max()), float(diff.max())


def splat_unique_bits(scene, cfg):
    """The splat kernels against t1_splats_plain on a chunk of 128 paths
    whose splats land on distinct pixels of a 4096^2 film: the film bit
    for bit, so each splat's contribution and pixel are the plain
    version's."""
    from tputracer_torch.integrators import bdpt, bdpt_cuda

    cfg = cfg.with_(width=4096, height=4096)
    n_pix = cfg.width * cfg.height
    uid = torch.arange(128, dtype=torch.int64, device="cuda")
    ys = bdpt.light_subpaths(scene, uid, cfg)
    zs = bdpt.eye_subpaths(scene, uid, cfg)
    with splat_adds() as adds:
        film_p = bdpt.t1_splats_plain(scene, cfg, ys, zs)
    ids = torch.cat([i for i, _ in adds])
    ids = ids[ids < n_pix]
    check(ids.numel() > 100 and ids.unique().numel() == ids.numel(),
          f"splat: {ids.numel()} splats on {ids.unique().numel()} pixels")
    film_k = bdpt_cuda.t1_splats_cuda(scene, cfg, ys, zs)
    check(torch.equal(film_k, film_p), "splat: on distinct pixels the film "
                                       "is not t1_splats_plain's bit for bit")
    return ids.numel()


def phase_splat(sc, n, frame):
    """The rest of phase 19: BDPT's splat kernels against the torch version
    on a benchmark chunk, timed, and the benchmark's frame graphed."""
    from tputracer_torch import graphs
    from tputracer_torch.api import render_bdpt
    from tputracer_torch.config import BdptConfig
    from tputracer_torch.integrators import bdpt, bdpt_cuda

    t0 = time.perf_counter()
    cfg = BdptConfig(width=1024, height=1024, spp=1, max_bounces=4,
                     chunk_size=n)
    uid = torch.arange(n, dtype=torch.int64, device="cuda")
    with torch.no_grad():
        unique = {p: splat_unique_bits(sc, cfg.with_(mis_power=p))
                  for p in (False, True)}
        zs = bdpt.eye_subpaths(sc, uid, cfg)
        ys = bdpt.light_subpaths(sc, uid, cfg)
        errs = [splat_bits(sc, cfg.with_(mis_power=p), ys, zs)
                for p in (False, True)]
        clear = torch.zeros(n, dtype=torch.bool, device="cuda")

        def unoccluded(s, o, d, tmax):
            return clear

        def kernels():
            bdpt_cuda.t1_splats_cuda(sc, cfg, ys, zs, occl=unoccluded)

        def plain():
            bdpt.t1_splats_plain(sc, cfg, ys, zs, occl=unoccluded)

        def phase():
            bdpt.t1_splats(sc, cfg, ys, zs)

        def plain_phase():
            bdpt.t1_splats_plain(sc, cfg, ys, zs)

        nbytes = splat_bytes_per_lane(len(ys), cfg.max_bounces + 2)
        film_bytes = 2 * 12 * cfg.width * cfg.height   # zeroed, then added
        bound_ms, bound_by = bound(0, nbytes * n + film_bytes)
        times = dict(lanes=n, bytes_per_lane=nbytes, film_bytes=film_bytes,
                     bound_ms=bound_ms, bound_by=bound_by,
                     ms=cuda_ms(kernels, 2, 5), device_ms=device_ms(kernels),
                     graph_ms=graph_ms(kernels),
                     plain_ms=cuda_ms(plain, 2, 5),
                     plain_graph_ms=graph_ms(plain, reps=2),
                     phase_graph_ms=graph_ms(phase),
                     plain_phase_graph_ms=graph_ms(plain_phase, reps=2))
    emit("splat", **times)
    del zs, ys
    graphs.clear()
    launches = []
    for _ in range(3):   # eager, the capture, a replay
        before = splat_launches()
        render_bdpt(sc, frame)
        torch.cuda.synchronize()
        launches.append(splat_launches() - before)
    census = graphs.graphs()[0].census
    nodes = {k: census[k] for k in ("splat_prepare_kernel",
                                    "splat_finish_kernel",
                                    "connect_table_kernel")}
    check(launches == [8] * 3, f"splat: launches {launches} a frame, want 8")
    # the table fills: 2 a chunk for the connections, 2 for the splats
    check(list(nodes.values()) == [4, 4, 16],
          f"splat: the frame's graph holds {nodes}")
    graphs.clear()
    res = dict(frame_launches=launches, graph_nodes=nodes,
               kernel_nodes=census["kernel_nodes"],
               unique_pixel_splats=unique,
               max_over_bound=max(e[0] for e in errs),
               max_abs_err=max(e[1] for e in errs),
               seconds=time.perf_counter() - t0)
    emit("splat", **res)
    return times, res


def phase_connect():
    """Phase 19: BDPT's connection kernels against the torch version on a
    benchmark chunk, timed, and the benchmark's frame graphed."""
    from tputracer_torch import graphs
    from tputracer_torch.api import render_bdpt
    from tputracer_torch.config import BdptConfig
    from tputracer_torch.integrators import bdpt, bdpt_cuda
    from tputracer_torch.scene import cornell_box

    t0 = time.perf_counter()
    sc = cornell_box("caustic", device="cuda")
    n = 1 << 20
    cfg = BdptConfig(width=1024, height=1024, spp=1, max_bounces=4,
                     chunk_size=n)
    uid = torch.arange(n, dtype=torch.int64, device="cuda")
    with torch.no_grad():
        zs = bdpt.eye_subpaths(sc, uid, cfg)
        ys = bdpt.light_subpaths(sc, uid, cfg)
        max_abs = max(connect_bits(sc, cfg.with_(mis_power=p), ys, zs)
                      for p in (False, True))
        clear = torch.zeros(n, dtype=torch.bool, device="cuda")

        def unoccluded(s, o, d, tmax):
            return clear

        def kernels():
            bdpt_cuda.connection_radiance_cuda(sc, cfg, ys, zs,
                                               occl=unoccluded)

        def plain():
            bdpt.connection_radiance_plain(sc, cfg, ys, zs, occl=unoccluded)

        def phase():
            bdpt.connection_radiance(sc, cfg, ys, zs)

        def plain_phase():
            bdpt.connection_radiance_plain(sc, cfg, ys, zs)

        nbytes = connect_bytes_per_lane(len(zs), len(ys), cfg.max_bounces + 2)
        bound_ms, bound_by = bound(0, nbytes * n)
        times = dict(lanes=n, bytes_per_lane=nbytes, bound_ms=bound_ms,
                     bound_by=bound_by, ms=cuda_ms(kernels, 2, 5),
                     device_ms=device_ms(kernels), graph_ms=graph_ms(kernels),
                     plain_ms=cuda_ms(plain, 2, 5),
                     plain_graph_ms=graph_ms(plain, reps=2),
                     phase_graph_ms=graph_ms(phase),
                     plain_phase_graph_ms=graph_ms(plain_phase, reps=2))
    emit("connect", **times)
    del zs, ys
    frame = BdptConfig(width=512, height=512, spp=16, max_bounces=4,
                       chunk_size=n)
    graphs.clear()
    launches = []
    for _ in range(3):   # eager, the capture, a replay
        before = connect_launches()
        render_bdpt(sc, frame)
        torch.cuda.synchronize()
        launches.append(connect_launches() - before)
    census = graphs.graphs()[0].census
    nodes = {k: census[k] for k in ("connect_prepare_kernel",
                                    "connect_finish_kernel",
                                    "connect_table_kernel")}
    check(launches == [8] * 3, f"connect: launches {launches} a frame, "
                               f"want 8")
    # the table fills: 2 a chunk for the connections, 2 for the splats
    check(list(nodes.values()) == [4, 4, 16],
          f"connect: the frame's graph holds {nodes}")
    graphs.clear()
    res = dict(frame_launches=launches, graph_nodes=nodes,
               kernel_nodes=census["kernel_nodes"], max_abs_err=max_abs,
               seconds=time.perf_counter() - t0)
    emit("connect", **res)
    return times, res, phase_splat(sc, n, frame)


# ---- phase 20: PT's bounce kernels (csrc/pt.cu) -----------------------------

# the bytes each class of lane needs in the two PT kernels of a full
# bounce, every array each kernel reads or writes counted once a kernel
# (the scene's tables stay in cache and are not counted):
#   dead, a lane dead at the bounce's start: prepare reads alive 1 and
#     writes stmax 4; finish reads alive 1
#   miss, alive and hitting nothing: prepare reads alive 1, t 4 and writes
#     stmax 4, flags 1; finish reads alive 1, flags 1 and writes alive 1,
#     tmax 4
#   hit, alive and hitting something: prepare reads alive 1, t 4, prim 4,
#     o 12, d 12, thr 12, prev_delta 1, uid 8, L 12 and writes L 12,
#     stmax 4, flags 1; finish reads alive 1, flags 1, o 12, d 12, t 4,
#     prim 4, uid 8, thr 12 and writes o 12, d 12, thr 12, prev_delta 1,
#     prev_pdf 4, alive 1, tmax 4
#   shadow, a hit's shadow ray, more: prepare writes so 12, sd 12,
#     contrib 12; finish reads occ 1 and, the ray clear, contrib 12, L 12
#     and writes L 12
# and PT_MIS_BYTES more a hit where MIS weighs the emission (mis on, past
# bounce 0): prepare reads prev_pdf 4
PT_LANE_BYTES = dict(dead=5 + 1, miss=10 + 7, hit=83 + 100, shadow=36 + 37)
PT_MIS_BYTES = 4


def pt_bytes(n, issued, active, shadow, mis_weighs):
    """The bytes the two PT kernels of a full bounce need on a chunk of n
    lanes: issued of them alive at its start, active of those hitting
    something, shadow of those tracing a clear shadow ray
    (PT_LANE_BYTES)."""
    per = PT_LANE_BYTES
    hit = per["hit"] + (PT_MIS_BYTES if mis_weighs else 0)
    return ((n - issued) * per["dead"] + (issued - active) * per["miss"]
            + active * hit + shadow * per["shadow"])


def pt_launches():
    """cuda_build's launch counts of the two PT kernels, summed."""
    from tputracer_torch.cuda_build import LAUNCHES

    return LAUNCHES["pt_prepare_kernel"] + LAUNCHES["pt_finish_kernel"]


def pt_start(sc, cfg, n, offset=0):
    """(uid, carry) of a chunk of n paths from uid ``offset`` on the card,
    as trace_radiance starts it, the camera's origins contiguous."""
    from tputracer_torch.integrators.pt import camera_rays

    uid = torch.arange(offset, offset + n, dtype=torch.int64, device="cuda")
    o, d = camera_rays(sc, uid, cfg)
    f32 = dict(dtype=torch.float32, device="cuda")
    ones = torch.ones((n,), dtype=torch.bool, device="cuda")
    return uid, (o.contiguous(), d, torch.zeros((n, 3), **f32),
                 torch.ones((n, 3), **f32), ones, ones.clone(),
                 torch.zeros((n,), **f32))


def ulps(a, b):
    """The largest distance in units in the last place between two float32
    tensors of one sign pattern (0 where they are equal)."""
    if a.numel() == 0:
        return 0
    return int((a.view(torch.int32).long()
                - b.view(torch.int32).long()).abs().max())


def bits_err(who, name, g, w, where):
    """The largest |g - w| of two tensors that must be equal bit for bit
    (0 for other dtypes); raises with it, the lanes that differ and their
    distance in ulps, if they are not."""
    err = 0.0
    if g.dtype == torch.float32 and g.numel():
        err = float(torch.where(g == w, 0.0, (g - w).abs()).max())
    if not torch.equal(g, w):
        lanes = int((g != w).reshape(g.shape[0], -1).any(1).sum()
                    if g.dim() else 1)
        far = (f"{ulps(g, w)} ulps, max abs err {err}"
               if g.dtype == torch.float32 else "")
        raise SmokeFailure(f"{who}: {name} differs on {lanes} lanes ({far}) "
                           f"at {where}")
    return err


def pt_bounce_bits(sc, cfg, n, offset=0):
    """Each bounce of a chunk of n paths through the kernels
    (pt_cuda.bounce_cuda) and through _bounce_step_plain from the same
    carry, both with the card's intersectors (accel.intersect, accel.
    occluded): L, alive, the ray counts and the next closest-hit tmax bit
    for bit on every lane, and o, d, thr, prev_delta and prev_pdf on
    every lane still alive (a dead lane's are never read again; the torch
    version overwrites them, the kernels leave them).  The plain carry goes
    on to the next bounce.  Returns the live lanes after each bounce and
    the largest |kernels - plain| over every float32 value compared (the
    counts as float32); raises on any differing bit, with that
    difference."""
    from tputracer_torch.accel import intersect, occluded
    from tputracer_torch.integrators import pt, pt_cuda

    names = ("o", "d", "L", "thr", "alive", "prev_delta", "prev_pdf")
    uid, carry = pt_start(sc, cfg, n, offset)
    wave = pt_cuda.Wavefront(sc, uid, cfg)
    live, err = [], 0.0

    def compare(name, g, w, where):
        nonlocal err
        err = max(err, bits_err("pt", name, g, w, where))

    with torch.no_grad():
        for b in range(cfg.max_bounces + 1):
            want, st_p = pt._bounce_step_plain(sc, None, uid, carry, b=b,
                                               cfg=cfg, isect=intersect,
                                               occl=occluded)
            wave.tmax = torch.where(carry[4], BIG, 0.0)
            before = pt_launches()
            got, st_k = pt_cuda.bounce_cuda(
                wave, uid, tuple(x.clone() for x in carry), b=b)
            torch.cuda.synchronize()
            last = b == cfg.max_bounces
            check(pt_launches() == before + (1 if last else 2),
                  f"pt: {pt_launches() - before} launches at bounce {b}")
            alive = want[4]
            where = f"{n} lanes, bounce {b}, {cfg}"
            for k, (g, w) in enumerate(zip(got, want)):
                m = slice(None) if names[k] in ("L", "alive") else alive
                compare(names[k], g[m], w[m], where)
            if not last:
                compare("the next tmax", wave.tmax,
                        torch.where(alive, BIG, 0.0), where)
            for name, k, p in zip(("rays_closest", "alive", "rays_shadow"),
                                  st_k, st_p):
                check((k is None) == (p is None),
                      f"pt: {name} {k} against {p} at {where}")
                if k is not None:
                    compare(name, k.to(torch.float32), p, where)
            live.append(int(alive.sum()))
            carry = want
    return live, err


def pt_times(n):
    """The two kernels of bounce 1 of a config-1 chunk of n paths, and
    _bounce_step_plain's shading of the same bounce, each with its
    closest hit given and every shadow ray clear (no intersection
    kernel): inside a CUDA graph (graph_ms), the kernels less the copies
    that put their in-place carry back before each call, beside their
    bound: the bytes that bounce's lanes need (pt_bytes of the ray counts
    of one call, MIS off as in config 1)."""
    from tputracer_torch.accel import (closest, finalize_hit, intersect,
                                       occluded)
    from tputracer_torch.config import RenderConfig
    from tputracer_torch.integrators import pt, pt_cuda
    from tputracer_torch.scene import cornell_box

    sc = cornell_box("boxes", device="cuda")
    cfg = RenderConfig(width=1024, height=1024, spp=1, max_bounces=4)
    uid, carry = pt_start(sc, cfg, n)
    with torch.no_grad():
        carry, _ = pt._bounce_step_plain(sc, None, uid, carry, b=0, cfg=cfg,
                                         isect=intersect, occl=occluded)
        carry = tuple(x.contiguous() for x in carry)
        t, prim = closest(sc, carry[0], carry[1], torch.zeros_like(carry[6]),
                          torch.where(carry[4], BIG, 0.0))
        clear = torch.zeros((n,), dtype=torch.bool, device="cuda")
        wave = pt_cuda.Wavefront(sc, uid, cfg)
        tmax0 = torch.where(carry[4], BIG, 0.0)
        work = tuple(x.clone() for x in carry)

        def restore():
            for dst, src in zip(work, carry):
                dst.copy_(src)
            wave.tmax.copy_(tmax0)

        def kernels():
            restore()
            pt_cuda.bounce_cuda(wave, uid, work, b=1,
                                closest=lambda *a: (t, prim),
                                occl=lambda *a, **k: clear)

        def plain():
            pt._bounce_step_plain(
                sc, None, uid, carry, b=1, cfg=cfg,
                isect=lambda s, o, d, tmin, tmax: finalize_hit(
                    s, o, d, t, prim, t < tmax),
                occl=lambda *a, **k: clear)

        wave.counts.zero_()
        kernels()
        issued, active, shadow = wave.counts[:, 1].tolist()
        wave.counts.zero_()
        nbytes = pt_bytes(n, issued, active, shadow, cfg.mis)
        bound_ms, bound_by = bound(0, nbytes)
        restore_ms = graph_ms(restore)
        return dict(lanes=n, live=issued, active=active, shadow=shadow,
                    bytes=nbytes, bytes_per_live_lane=nbytes / issued,
                    bound_ms=bound_ms, bound_by=bound_by,
                    graph_ms=graph_ms(kernels) - restore_ms,
                    restore_graph_ms=restore_ms,
                    plain_graph_ms=graph_ms(plain, reps=2))


def phase_pt(mesh):
    """Phase 20: PT's bounce kernels against _bounce_step_plain on config
    1's and config 2's chunks and one of config 3's, timed, and config 1's
    frame graphed."""
    from tputracer_torch import graphs
    from tputracer_torch.api import render
    from tputracer_torch.config import RenderConfig
    from tputracer_torch.scene import cornell_box

    t0 = time.perf_counter()
    boxes, spheres = (cornell_box(v, device="cuda")
                      for v in ("boxes", "spheres"))
    c1 = RenderConfig(width=512, height=512, spp=16, max_bounces=4)
    c2 = RenderConfig(**SPHERES_CFG)
    bits = {"config 1": pt_bounce_bits(boxes, c1, 1 << 20),
            "config 2": pt_bounce_bits(spheres, c2, 1 << 20),
            "config 2 mis": pt_bounce_bits(spheres, c2.with_(mis=True),
                                           1 << 20, offset=1 << 20),
            "config 3": pt_bounce_bits(mesh, RenderConfig(**MESH_CFG),
                                       1 << 16)}
    max_abs = max(err for _, err in bits.values())
    times = pt_times(1 << 20)
    emit("pt", live_after_each_bounce={k: v[0] for k, v in bits.items()},
         max_abs_err=max_abs, **times)
    graphs.clear()
    launches = []
    for _ in range(3):   # eager, the capture, a replay
        before = pt_launches()
        render(boxes, c1)
        torch.cuda.synchronize()
        launches.append(pt_launches() - before)
    census = graphs.graphs()[0].census
    nodes = {k: census[k] for k in ("pt_prepare_kernel", "pt_finish_kernel",
                                    "uniform3_kernel")}
    check(launches == [4 * 9] * 3, f"pt: launches {launches} a frame, "
                                   f"want 36")
    check(list(nodes.values()) == [20, 16, 4],
          f"pt: the frame's graph holds {nodes}")
    graphs.clear()
    res = dict(frame_launches=launches, graph_nodes=nodes,
               kernel_nodes=census["kernel_nodes"], max_abs_err=max_abs,
               seconds=time.perf_counter() - t0)
    emit("pt", **res)
    return times, res


# ---- phase 21: the capacity scene through api.render -----------------------


def plain_walk_blocks(walk_in, args, leaf, any_hit, block=4096):
    """clustered._traverse in blocks of rays: its (rays, C, 3) slab test
    at C = 18,304 does not fit at once; each ray's walk is its own, so the
    bits are the whole call's."""
    from tputracer_torch.accel.clustered import _traverse

    outs = [_traverse(*(x[s:s + block] for x in walk_in), *args, leaf=leaf,
                      any_hit=any_hit)
            for s in range(0, walk_in[0].shape[0], block)]
    return (torch.cat([t for t, _ in outs]),
            torch.cat([p for _, p in outs]))


def phase_capacity():
    """Phase 21: the capacity scene through api.render at the mesh cell's
    settings, counted, and the tree walk held to the plain walk on that
    render's own calls, timed beside its visit bound."""
    from perfbench.visit_bound import visit_work
    from tputracer_torch import cuda_build, graphs
    from tputracer_torch.accel import traverse_cuda as tc
    from tputracer_torch.accel.clustered import traverse_args
    from tputracer_torch.api import render
    from tputracer_torch.config import RenderConfig
    from tputracer_torch.integrators.pt import trace_radiance
    from tputracer_torch.scene import mesh_scene

    t0 = time.perf_counter()
    sc = mesh_scene(device="cuda", **CAP_SCENE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    max_clusters = tc.LIB.limit("tpt_traverse_max_clusters")
    check(sc.n_clusters > max_clusters,
          f"capacity: {sc.n_clusters} clusters, the flat scan stages "
          f"{max_clusters}")
    cfg = RenderConfig(**MESH_CFG)
    chunks = -(-cfg.width * cfg.height * cfg.spp // cfg.chunk_size)
    want = chunks * (2 * cfg.max_bounces + 1)
    graphs.clear()
    launches, imgs = [], []
    for call in range(3):   # eager, the capture, a replay
        cuda_build.LAUNCHES["traverse_kernel"] = 0
        img, _ = render(sc, cfg)
        torch.cuda.synchronize()
        launches.append(cuda_build.LAUNCHES["traverse_kernel"])
        imgs.append(img)
        if call == 0:   # the eager frame's sums (zeroed at its start)
            counts = tc.counts_of(sc.device).tolist()
    check(launches == [want] * 3,
          f"capacity: {launches} tree-walk launches a call, want {want}")
    check(all(torch.equal(i, imgs[0]) for i in imgs[1:]),
          "capacity: the graphed render differs from the eager one")
    nodes, visits, rays = counts
    check(rays > 0 and nodes < 0.1 * sc.n_clusters * rays,
          f"capacity: the walk's counts {counts}")
    graphs.clear()
    render_s = time.perf_counter() - t0 - build_s

    # every call of the render's first chunk, held bit for bit
    closest, shadow, isect, occl = recording_hooks()
    uid = torch.arange(cfg.chunk_size, dtype=torch.int64, device="cuda")
    trace_radiance(sc, uid, cfg, intersect_fn=isect, occluded_fn=occl)
    check(len(closest) == cfg.max_bounces + 1
          and len(shadow) == cfg.max_bounces,
          f"capacity: {len(closest)} closest and {len(shadow)} shadow calls")
    args = traverse_args(sc)
    max_abs, live = 0.0, []
    for k, (rays_k, any_hit) in enumerate(
            [(r, False) for r in closest] + [(r, True) for r in shadow]):
        o, d, tmin, tmax = rays_k
        walk_in = (o, d, tmin, tmax, tmax.clone(),
                   torch.full(tmax.shape, -1, dtype=torch.int32,
                              device="cuda"))
        before = cuda_build.LAUNCHES["traverse_kernel"]
        t_k, p_k = tc.traverse_cuda(*walk_in, *args, leaf=sc.leaf_size,
                                    any_hit=any_hit)
        t_p, p_p = plain_walk_blocks(walk_in, args, sc.leaf_size, any_hit)
        torch.cuda.synchronize()
        check(cuda_build.LAUNCHES["traverse_kernel"] == before + 1,
              "capacity: a call was not one tree-walk launch")
        err = float((t_k - t_p).abs().max())
        check(torch.equal(t_k, t_p) and torch.equal(p_k, p_p),
              f"capacity: the tree walk differs from the plain walk on "
              f"call {k} ({'any' if any_hit else 'closest'} hit): "
              f"{int((p_k != p_p).sum())} prims, t err {err}")
        max_abs = max(max_abs, err)
        live.append(int((tmax > tmin).sum()))

    # bounce 0's closest-hit call timed, beside its visit bound
    o, d, tmin, tmax = closest[0]
    walk_in = (o, d, tmin, tmax, tmax.clone(),
               torch.full(tmax.shape, -1, dtype=torch.int32, device="cuda"))

    def kernel():
        return tc.traverse_cuda(*walk_in, *args, leaf=sc.leaf_size)

    def plain():
        return plain_walk_blocks(walk_in, args, sc.leaf_size, False)

    t_final, _ = kernel()
    ops, nbytes = visit_work(o, d, tmin, tmax, t_final, args, sc.leaf_size)
    bound_ms, bound_by = bound(ops, nbytes)
    times = {"lanes": o.shape[0], "ms": cuda_ms(kernel, 2, 5),
             "device_ms": device_ms(kernel), "graph_ms": graph_ms(kernel),
             "plain_ms": cuda_ms(plain, 0, 1), "bound_ms": bound_ms,
             "bound_by": bound_by, "bound_bytes": nbytes}
    res = dict(n_tris=sc.n_tris, n_clusters=sc.n_clusters,
               top_nodes=sc.top_min.shape[0], frame_launches=launches,
               boxes_per_ray=nodes / rays, clusters_per_ray=visits / rays,
               calls_held=len(live), live_rays=live, max_abs_err=max_abs,
               build_s=build_s, render_s=render_s,
               seconds=time.perf_counter() - t0)
    emit("capacity", **res, **times)
    return times, res


# ---- phase 22: BDPT's walk kernel (csrc/walk.cu) ----------------------------

# the bytes each class of lane needs in the walk kernel of one vertex,
# every array read or written counted once (the scene's tables stay in
# cache and are not counted):
#   dead, a lane dead at the vertex's start: reads alive 1 and writes
#     pdf_fwd, pdf_rev, mat and prim 4 each, delta and valid 1 each, and
#     zeros into p, ng and wo, 12 each; on all but the walk's last vertex
#     also zeros into the next beta, 12 (dead_next)
#   miss, alive and hitting nothing: reads alive 1, t 4 and writes those
#     54; on all but the walk's last vertex also alive 1, tmax 4 and the
#     next beta 12 (miss_next)
#   hit, a valid vertex: reads alive 1, t 4, prim 4, o 12, d 12, the
#     previous point 12, pdf_sa 4 and writes p, ng and wo 12 each and the
#     18; on all but the last vertex (hit_next) also reads uid 8, beta 12
#     and writes the next beta, o and d 12 each, pdf_sa 4, alive 1, tmax
#     4, and with a previous vertex (hit_prev) reads its normal 12 and
#     writes its pdf_rev 4
WALK_LANE_BYTES = dict(dead=1 + 54, dead_next=12, miss=5 + 54,
                       miss_next=5 + 12, hit=49 + 54, hit_next=20 + 45,
                       hit_prev=12 + 4)
# the fields the kernel gives the torch version's bits on every lane
WALK_EVERY_LANE = ("valid", "delta", "pdf_fwd", "pdf_rev", "mat", "prim")


def walk_bytes_per_lane(last, has_prev):
    """The bytes a lane of each class (dead, miss, hit) needs in one walk
    kernel launch (WALK_LANE_BYTES): of the walk's last vertex or not, and
    with a previous vertex whose pdf_rev it writes or not."""
    b = WALK_LANE_BYTES
    hit = b["hit"]
    if not last:
        hit += b["hit_next"] + (b["hit_prev"] if has_prev else 0)
    return {"dead": b["dead"] + (0 if last else b["dead_next"]),
            "miss": b["miss"] + (0 if last else b["miss_next"]), "hit": hit}


def walk_launches():
    """cuda_build's launch count of the walk kernel."""
    from tputracer_torch.cuda_build import LAUNCHES

    return LAUNCHES["walk_kernel"]


def walk_bits(sc, cfg, n, offset=0):
    """Both walks of a chunk of n paths from uid ``offset``, by
    eye_subpaths and light_subpaths on the card, through the walk kernel
    (the default intersector) and through _walk_plain (the card's
    intersector, accel.intersect, injected): every field of every vertex
    bit for bit on the lanes valid there, valid, delta, pdf_fwd, pdf_rev,
    mat and prim on every lane, beta on the lanes valid at the vertex
    before (every lane at the first), zeros in p, ng, wo and beta on the
    lanes those leave out, the camera vertex and the light's y0 whole,
    and rays_closest bit for bit; one launch a vertex.  Returns
    the valid lanes at each vertex of each walk and the largest |kernel -
    plain| over every float32 value compared; raises on any differing
    bit, with that difference."""
    from tputracer_torch.accel import intersect
    from tputracer_torch.integrators import bdpt

    uid = torch.arange(offset, offset + n, dtype=torch.int64, device="cuda")
    live, err = {}, 0.0
    with torch.no_grad():
        for walk, subpaths in (("eye", bdpt.eye_subpaths),
                               ("light", bdpt.light_subpaths)):
            got, want = {}, {}
            before = walk_launches()
            ks = subpaths(sc, uid, cfg, stats_acc=got)
            ps = subpaths(sc, uid, cfg, isect=intersect, stats_acc=want)
            torch.cuda.synchronize()
            check(walk_launches() == before + cfg.max_bounces + 1,
                  f"walk: {walk_launches() - before} launches for the "
                  f"{walk} walk")
            for v, (k, p) in enumerate(zip(ks, ps)):
                where = f"the {walk} walk's vertex {v}, {n} lanes, {cfg}"
                check(k.keys() == p.keys(), f"walk: fields {list(k)} at "
                                            f"{where}")
                for f in p:
                    on = (slice(None) if v == 0 or f in WALK_EVERY_LANE
                          else p["valid"])
                    if f == "beta":   # the kernel computes it off a valid
                        on = slice(None) if v <= 1 else ps[v - 1]["valid"]
                    err = max(err, bits_err("walk", f, k[f][on], p[f][on],
                                            where))
                    if not isinstance(on, slice):   # zeros everywhere else
                        off = k[f][~on]
                        err = max(err, bits_err("walk", f"{f} off its lanes",
                                                off, torch.zeros_like(off),
                                                where))
            err = max(err, bits_err("walk", "rays_closest",
                                    got["rays_closest"],
                                    want["rays_closest"], f"the {walk} walk"))
            live[walk] = [int(v["valid"].sum()) for v in ps[1:]]
    return live, err


def walk_times(sc, cfg, n):
    """The eye walk of a chunk of n paths, its closest hits given (recorded
    from a first walk): the kernel route (bdpt_cuda.walk_cuda, less the
    copies that put its in-place carry back before each call) and
    _walk_plain, each inside a CUDA graph (graph_ms), beside their bound:
    the bytes each vertex's lanes need (walk_bytes_per_lane of its own
    counts), summed over the walk's vertices."""
    from tputracer_torch import rng
    from tputracer_torch.accel import closest, finalize_hit
    from tputracer_torch.integrators import bdpt, bdpt_cuda
    from tputracer_torch.integrators.pt import camera_rays

    uid = torch.arange(n, dtype=torch.int64, device="cuda")
    n_verts = cfg.max_bounces + 1
    with torch.no_grad():
        o, d = camera_rays(sc, uid, cfg)
        o = o.contiguous()
        pdf = bdpt._camera_pdf_sa(sc.camera, d)
        beta = torch.ones((n, 3), dtype=torch.float32, device="cuda")
        work = [o.clone(), d.clone(), pdf.clone()]
        hits = []

        def recording(*args):
            hits.append(closest(*args))
            return hits[-1]

        def walk_args(carry):
            return (sc, carry[0], carry[1], beta, carry[2], uid, cfg, n_verts,
                    rng.SLOT_BSDF, None, True)

        verts = bdpt_cuda.walk_cuda(*walk_args(work), closest=recording)

        def restore():
            for dst, src in zip(work, (o, d, pdf)):
                dst.copy_(src)

        def kernels():
            restore()
            given = iter(hits)
            bdpt_cuda.walk_cuda(*walk_args(work),
                                closest=lambda *a: next(given))

        def plain():
            given = iter(hits)

            def isect(s, o_, d_, tmin, tmax):
                t, prim = next(given)
                return finalize_hit(s, o_, d_, t, prim, t < tmax)

            bdpt._walk_plain(*walk_args((o, d, pdf)), isect=isect)

        nbytes, issued, valid = 0, n, []
        for i, v in enumerate(verts):
            ok = int(v["valid"].sum())
            per = walk_bytes_per_lane(i == n_verts - 1, i > 0)
            nbytes += ((n - issued) * per["dead"] + (issued - ok) * per["miss"]
                       + ok * per["hit"])
            valid.append(ok)
            if i + 1 < n_verts:
                issued = int((v["valid"]
                              & (verts[i + 1]["beta"].amax(-1) > 0.0)).sum())
        bound_ms, bound_by = bound(0, nbytes)
        restore_ms = graph_ms(restore)
        walk_ms = graph_ms(kernels) - restore_ms
        return dict(lanes=n, verts=n_verts, valid=valid, bytes=nbytes,
                    bytes_per_valid_vertex=nbytes / sum(valid),
                    bound_ms=bound_ms, bound_by=bound_by, graph_ms=walk_ms,
                    vertex_graph_ms=walk_ms / n_verts,
                    restore_graph_ms=restore_ms,
                    plain_graph_ms=graph_ms(plain, reps=2))


def phase_walk(mesh):
    """Phase 22: BDPT's walk kernel against _walk_plain on a caustic chunk
    and a mesh chunk, trace_bdpt's L_own on both walk routes, timed, and
    the benchmark's frame graphed."""
    from tputracer_torch import graphs, trace
    from tputracer_torch.accel import intersect
    from tputracer_torch.api import render_bdpt
    from tputracer_torch.config import BdptConfig
    from tputracer_torch.integrators import bdpt
    from tputracer_torch.scene import cornell_box

    t0 = time.perf_counter()
    sc = cornell_box("caustic", device="cuda")
    n = 1 << 20
    cfg = BdptConfig(width=1024, height=1024, spp=1, max_bounces=4,
                     chunk_size=n)
    m_cfg = BdptConfig(width=256, height=256, spp=1, max_bounces=4,
                       chunk_size=1 << 16)
    bits = {"caustic": walk_bits(sc, cfg, n),
            "mesh": walk_bits(mesh, m_cfg, 1 << 16)}
    max_abs = max(err for _, err in bits.values())

    # the whole chunk: L_own and the ray counts bit for bit on both walk
    # routes, the walk phases counting the route
    uid = torch.arange(n, dtype=torch.int64, device="cuda")
    kernel_counts = []
    with torch.no_grad():
        outs = []
        for isect in (None, intersect):
            trace.reset()
            outs.append(bdpt.trace_bdpt(sc, uid, cfg, intersect_fn=isect))
            kernel_counts.append([trace.records(f"bdpt.{w}_walk")[-1].counts[
                "kernel"] for w in ("eye", "light")])
        trace.reset()
    (L_k, _, st_k), (L_p, _, st_p) = outs
    check(kernel_counts == [[1, 1], [0, 0]],
          f"walk: the walk phases count kernel {kernel_counts}")
    check(torch.equal(L_k, L_p), "walk: L_own differs between the walk "
                                 "routes")
    check(all(torch.equal(st_k[k], st_p[k]) for k in st_p),
          "walk: the ray counts differ between the walk routes")
    del outs, L_k, L_p
    times = walk_times(sc, cfg, n)
    emit("walk", valid_at_each_vertex={k: v[0] for k, v in bits.items()},
         max_abs_err=max_abs, **times)

    frame = BdptConfig(width=512, height=512, spp=16, max_bounces=4,
                       chunk_size=n)
    graphs.clear()
    launches = []
    for _ in range(3):   # eager, the capture, a replay
        before = walk_launches()
        render_bdpt(sc, frame)
        torch.cuda.synchronize()
        launches.append(walk_launches() - before)
    census = graphs.graphs()[0].census
    want = 4 * 2 * (frame.max_bounces + 1)
    check(launches == [want] * 3, f"walk: launches {launches} a frame, "
                                  f"want {want}")
    check(census["walk_kernel"] == want,
          f"walk: the frame's graph holds {census['walk_kernel']}")
    graphs.clear()
    res = dict(frame_launches=launches, graph_nodes=census["walk_kernel"],
               kernel_nodes=census["kernel_nodes"], max_abs_err=max_abs,
               seconds=time.perf_counter() - t0)
    emit("walk", **res)
    return times, res


def main():
    start = time.perf_counter()
    phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 stays float32
    torch.backends.cudnn.allow_tf32 = False
    mesh = phase_build()
    results, max_abs = phase_kernel()
    launches, c1_img = phase_render()
    free_graphs()
    phase_parity()
    t_results, t_max_abs = phase_traverse(mesh)
    t_launches, mesh_img, mesh_stats = phase_mesh_render(mesh)
    free_graphs()
    phase_mesh_parity()
    p_results = phase_pairs(mesh)
    p_launches = phase_pairs_render(mesh, mesh_img)
    free_graphs()
    phase_bdpt_kernel()
    b_launches, bdpt_img = phase_bdpt_render()
    free_graphs()
    phase_progressive(bdpt_img)
    free_graphs()
    fit_step, fit_step_remat, sampler_fit_step = phase_fit()
    free_graphs()
    dp1, tiled3, dp4, ring4, dp5 = phase_dist(c1_img, mesh_img, mesh_stats,
                                              bdpt_img.cpu().numpy())
    free_graphs()
    spheres_launches = phase_spheres()
    free_graphs()
    phase_graphs(mesh)
    s_times, s_renders, s_max_abs = phase_sampler(mesh)
    c_times, c_res, (sp_times, sp_res) = phase_connect()
    pt_t, pt_res = phase_pt(mesh)
    free_graphs()
    cap_t, cap_res = phase_capacity()
    free_graphs()
    walk_t, walk_res = phase_walk(mesh)
    emit("total", seconds=time.perf_counter() - start)
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
        "launches_config2": spheres_launches,
        "launches_bdpt": b_launches,
        "launches_fit_step": fit_step,
        "launches_fit_step_remat": fit_step_remat,
        "launches_dp_per_rank": dp1,
        "launches_dp_bdpt_per_rank": dp4,
        "launches_bdpt_ring_per_rank": ring4,
        "launches_dp_fit_step_per_rank": dp5,
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
        "launches_tiled_per_rank": tiled3,
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
    }, {
        "name": "uniform3",
        "route": "cuda",
        "source": "tputracer_torch/csrc/rng.cu",
        "replaces": None,    # no Pallas counterpart: XLA fuses the hash
        # the sampler's launches over a replay of each graph
        "launches": s_renders[0]["calls"][-1]["launches"],
        "launches_config3": s_renders[1]["calls"][-1]["launches"],
        "launches_fit_step": sampler_fit_step,
        "max_abs_err": s_max_abs,
        **{k: s_times[-1][k] for k in ("lanes", "ms", "device_ms", "graph_ms",
                                       "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
    }, {
        "name": "connect",
        "route": "cuda",
        "source": "tputracer_torch/csrc/connect.cu",
        "replaces": None,    # no Pallas counterpart: XLA fuses the strategies
        # the connection kernels' launches over a replay of the frame
        "launches": c_res["frame_launches"][-1],
        "max_abs_err": c_res["max_abs_err"],
        **{k: c_times[k] for k in ("lanes", "ms", "device_ms", "graph_ms",
                                   "plain_ms", "plain_graph_ms", "bound_ms",
                                   "bound_by")},
        "library_ms": None,
    }, {
        "name": "splat",
        "route": "cuda",
        "source": "tputracer_torch/csrc/connect.cu",
        "replaces": None,    # no Pallas counterpart: XLA fuses the splats
        # the splat kernels' launches over a replay of the frame
        "launches": sp_res["frame_launches"][-1],
        "max_abs_err": sp_res["max_abs_err"],
        **{k: sp_times[k] for k in ("lanes", "ms", "device_ms", "graph_ms",
                                    "plain_ms", "plain_graph_ms",
                                    "phase_graph_ms", "plain_phase_graph_ms",
                                    "bound_ms", "bound_by")},
        "library_ms": None,
    }, {
        "name": "pt",
        "route": "cuda",
        "source": "tputracer_torch/csrc/pt.cu",
        "replaces": None,    # no Pallas counterpart: XLA fuses the bounce
        # the PT kernels' launches over a replay of config 1's frame
        "launches": pt_res["frame_launches"][-1],
        "max_abs_err": pt_res["max_abs_err"],
        **{k: pt_t[k] for k in ("lanes", "live", "bytes_per_live_lane",
                                "graph_ms", "plain_graph_ms", "bound_ms",
                                "bound_by")},
        "library_ms": None,
    }, {
        "name": "tree_walk",
        "route": "cuda",
        "source": "tputracer_torch/csrc/traverse.cu",
        "replaces": None,    # the JAX package tiles such scenes instead
        # the walk's launches over each call of the capacity frame
        "launches": cap_res["frame_launches"][-1],
        "max_abs_err": cap_res["max_abs_err"],
        **{k: cap_t[k] for k in ("lanes", "ms", "device_ms", "graph_ms",
                                 "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
    }, {
        "name": "walk",
        "route": "cuda",
        "source": "tputracer_torch/csrc/walk.cu",
        "replaces": None,    # no Pallas counterpart: XLA fuses the walk
        # the walk kernel's launches over a replay of the frame
        "launches": walk_res["frame_launches"][-1],
        "max_abs_err": walk_res["max_abs_err"],
        **{k: walk_t[k] for k in ("lanes", "verts", "graph_ms",
                                  "vertex_graph_ms", "plain_graph_ms",
                                  "bound_ms", "bound_by")},
        "library_ms": None,
    }]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
