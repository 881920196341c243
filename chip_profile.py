#!/usr/bin/env python3
"""Where the render paths' time goes on one CUDA card.

    python3 chip_profile.py [--parent DIR] [--settled]
    python3 chip_profile.py --sass
    python3 chip_profile.py graphs

Run from the root of a checkout, after (or without) chip_smoke.py.  It
prints the card's name and power limit, then one JSON line per
measurement.  Config 1 (Cornell boxes, 512x512, 16 spp, 4 bounces, the
intersection kernel's path):

  * render_profile (config 1): the render's untraced time (median of 3
    after a warm-up), then one render under torch.profiler: kernels per
    render, the device's busy time (the union of its kernels' intervals),
    the intersection kernel's device time and share of it, the traced
    span, the top kernels, and the device's idle share of the untraced
    render (1 - busy / untraced median).
  * render_profile (config 4): the same for BASELINE config 4, BDPT on
    Cornell "caustic" at 128x128, 8 spp, 4 bounces, chunks of 2^15, and
    for that scene at 512x512, 16 spp, chunks of 2^18; before them a trace line per group of the intersection kernel's calls in its
    first chunk (chip_smoke's phase-11 groups), each group's calls traced
    20 times back to back: the kernel's device time a launch, the host's
    time a group.
  * fit_profile (config 5): a fit step of BASELINE config 5 (Cornell
    boxes, 128x128, 4 spp, 3 bounces, Adam), without and with remat: the
    untraced step, then the forward pass and the backward pass (with
    Adam's update) traced apart: kernels and busy time of each, the top
    kernels and ops, the device time of the table lookups' backward
    (lookup.fetch's one-hot matmul; IndexBackward0 where table[idx] is
    left) and its share of the backward, and the idle share.
    ``python3 -c "import chip_profile as c; c.fit_config5()"`` runs it
    alone.
  * lookup_backward: one lookup's backward alone at 2^16 and 2^20 lanes,
    five ways (lookup_backward_costs).
  * ``python3 -c "import chip_profile as c; c.lookups('DIR')"``, with an
    earlier commit unpacked in DIR as for ``--parent`` below: configs 1-4
    rendered by both checkouts in one process, their images' and ray
    counts' bits compared, launches and device kernels a render
    (render_bits); config 5's step of both in turns (fit_config5); and
    lookup_backward.

Config 3 tiled over two ranks that share the card (gloo), the geometry
split and the rays going round the ring (tputracer_torch.dist):

  * dist_profile: ``python3 -c "import chip_profile as c;
    c.dist_config3()"`` runs it (alone; main() does not).  Each rank
    renders config 3 through dist.render_tiled (the scene built on the
    host, its half of the clusters on the card) after a warm-up: the
    untraced render (median of 3, each from a barrier to a synchronize),
    then one render with rank 0 under torch.profiler: kernels, busy
    time, idle share, the traversal kernel's device time and share, the
    host's time in the hops (the ``dist.ring_hop`` spans: the copy to
    the host, gloo's send and receive, the copy back) and the copies'
    device time.
  * dist_profile of config 5: ``python3 -c "import chip_profile as c;
    c.dist_fit5()"``, a DP fit step (dist.fit_chain_sharded) in worlds
    of 1 and 2 gloo ranks on the card, rank 0 traced: the untraced step,
    kernels, busy time, idle share, the lookups' backward.
  * first_step: ``python3 -c "import chip_profile as c;
    c.first_step_costs()"`` (in a fresh process), a process's first Adam
    step on the card against its second.
  * span_off_cost, span_on_cost: ``python3 -c "import chip_profile as c;
    c.span_costs()"``, what the port's spans (tputracer_torch.trace) cost:
    a span's host time with no profiler running, and configs 1, 3 and 5
    traced with the spans' profiler ranges and without them, in turns.

Config 3, on the 102,410-triangle mesh of BASELINE config 3
(mesh_scene(subdiv=6)) and 2^16 random rays from inside its room
(chip_smoke.room_rays):

  * call: the whole pair route (accel.pairs._pair_traverse), the traversal
    kernel alone, and the traversal kernel on the route's fallback input
    (resolved rays with tmax = 0), each timed with CUDA events (median of
    5 after 2 warm-ups);
  * ab lines with a ``bounce``: the closest-hit rays of each bounce of a
    config-3 chunk recorded with cfg.sort_rays off and on, through the
    traversal kernel and through the pair route, in turns;
  * call_profile: one route call under torch.profiler: device time per
    kernel name, the device's busy time (the union of its kernels'
    intervals), the span from the first kernel's start to the last one's
    end, and the number of kernels;
  * render_profile: one config-3 render (256x256, 4 spp, 8 bounces) with
    the pair route and one with the default route, each after a warm-up:
    kernels per render, busy time, the traversal kernel's device time and
    share of it, the traced span, the top kernels, and the device's idle
    share of the untraced render (1 - busy / untraced median).

With ``--parent DIR`` (an earlier commit unpacked there, e.g. by
``git archive <commit> | tar -x -C DIR``), it also imports that checkout's
intersection, traversal and pair wrappers (accel.intersect_cuda with its
own scene_args, accel.traverse_cuda with its own accel.clustered.
traverse_args, accel.pairs and accel.pairs_cuda), which build that
checkout's kernels, and:

  * renders config 1 through the parent's intersection kernel too (its
    intersect_fused and occluded_fused as render_pt's hooks), the untraced
    renders in turns (parent, this, this, parent), and profiles it;
  * times config 5's step of both in turns (fit_config5) and compares the
    renders of configs 1-4 (render_bits);
  * prints an ``ab`` line per ray set: for the intersection kernel,
    chip_smoke's phase-3 sets at 2^20 rays (random rays on boxes and
    spheres, closest and any hit; the closest-hit and shadow rays of
    bounce 2 of config 1's first chunk); for the traversal kernel,
    config-3 camera rays, random rays at 2^16 and 2^18, closest hit, and
    the pair route's fallback input; for the pair route, on the same
    three sets: expand, the slots' best (expand, bin, test and fold) and
    the whole route.  The two sides' outputs must be equal bit for bit,
    and each is timed in turns (parent, this, this, parent), per single
    call (``ms``, cuda_ms) and on the card over 20 calls back to back
    (``device_ms``);
  * prints a ``trace`` line per ray set: the slots' best of each side
    traced over 20 calls back to back, and this side's pair-test call
    alone (its test and fold kernels): per call, the busy time, the span
    and the host's time; per kernel name, its launches and device time a
    launch.

With ``--settled`` it also re-runs two experiments whose outcome PERF.md
records and the code follows:

  * ab lines, kernel "fallback": the pair route's fallback walk on every
    ray in its own order (as the route calls it) against the unresolved
    rays sorted first with gathers and scatters around the walk, in turns;
  * with ``--parent`` on a commit from before the pair test took in its
    glue (2ed1656 or earlier): the parent's pair test on the pairs its
    glue gathers, folded as its glue folds, against this one's, in turns,
    with a trace line for each.

With ``--sass`` it only builds this checkout's intersection and pair
kernels and prints a sass line for each of three kernels: the innermost
loops, from cuobjdump -sass of the built library, that hold a division
(the intersection kernel's triangle loops, the pair test's row loop) or a
float min/max (expand's box loop, in its K <= 4 instance), with their
instructions, shared loads by width and opcode counts: per triangle, per
four rows or per four boxes.

``graphs`` only profiles the compiled entry points (graph_profiles):
configs 1, 3 and 4 each rendered through api.render / api.render_bdpt,
which replay a CUDA graph (tputracer_torch.graphs), and through the eager
render_pt / integrators.bdpt.render_bdpt, in turns after the capture (the
second graphed call)
(median of 3 untraced renders each), then one traced render each: device
events in the trace, busy time (the union of their intervals), the
intersection or traversal kernel's device time, idle share (1 - busy /
untraced median), the port's kernels in the trace by kernel
(graphs.kernel_of), and the graph's kernel nodes, which the trace must
reach (CUPTI reports a graph's kernels one by one), and its nodes of the
port's kernels, which the trace must not exceed (``trace_complete`` says
whether it matched them: CUPTI may drop a record).

Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from chip_smoke import (MESH_CFG, N_CHUNK, N_RAYS, card_line, cuda_ms,
                        device_ms, fallback_input, intersect_sets,
                        mesh_camera_rays, room_rays)


# the port's spans (tputracer_torch.trace), record_function ranges that
# the trace also shows on the card's timeline; they are not kernels
ANNOTATIONS = "tputracer."


def busy(prof, kernel="traverse_kernel"):
    """(kernels, busy ms, span ms, top kernels by device ms, device ms of
    the kernels whose name holds ``kernel``) of a trace."""
    ks = sorted((e.time_range.start, e.time_range.end, e.name)
                for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not e.name.startswith(ANNOTATIONS))
    total, end = 0.0, None
    by_name = {}
    for s, e, name in ks:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e3
        if end is None or s >= end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    span = (ks[-1][1] - ks[0][0]) / 1e3 if ks else 0.0
    mine = sum(ms for n, ms in by_name.items() if kernel in n)
    return len(ks), total / 1e3, span, [(n[:60], ms) for n, ms in top], mine


def traced(fn):
    """The torch.profiler trace of one call of fn, after one untraced."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return prof


def profiled(fn, kernel="traverse_kernel"):
    return busy(traced(fn), kernel)


def host_ms(fn, reps=100):
    """The host's time per call of fn: reps calls queued without waiting
    on the card (its launch queue holds more), after one call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed * 1e3 / reps


def per_call(fn, reps=20):
    """fn traced over ``reps`` calls back to back: per call, the kernels,
    the busy time and the span (busy well below the span: the card waited
    on the host); host_ms; and for each kernel name its launches in the
    trace and mean device ms a launch.  (The trace may miss a call's
    kernels: its launch counts say so.)"""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    n, busy_ms, span_ms, _, _ = busy(prof)
    launches, total = {}, {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not e.name.startswith(ANNOTATIONS)):
            name = e.name[:60]
            launches[name] = launches.get(name, 0) + 1
            total[name] = total.get(name, 0.0) + (e.time_range.end
                                                  - e.time_range.start) / 1e3
    return {"kernels": n / reps, "busy_ms": busy_ms / reps,
            "span_ms": span_ms / reps, "host_ms": host_ms(fn),
            "launches": launches,
            "ms_per_launch": {k: total[k] / launches[k] for k in total}}


def parent_modules(root):
    """The modules of the checkout at ``root``, as a namespace: cl
    (clustered), tc (traverse_cuda), ic (intersect_cuda), pairs and pc
    (pairs_cuda) of its accel; its api, config, fit, scene, the two
    integrators, pt and bdpt, and cb (cuda_build, whose library
    declarations and launch counts it needs).  Its package is imported
    under its own name while this one's modules are set aside, and its
    three kernel sources are built (into its own csrc/build) before they
    are put back."""
    name = "tputracer_torch"
    ours = {k: sys.modules.pop(k) for k in list(sys.modules)
            if k == name or k.startswith(name + ".")}
    sys.path.insert(0, str(Path(root).resolve()))
    try:
        mods = this_modules()
        for mod in (mods.tc, mods.ic, mods.pc):
            mod.LIB.load()
    finally:
        sys.path.pop(0)
        for k in [k for k in sys.modules
                  if k == name or k.startswith(name + ".")]:
            del sys.modules[k]
        sys.modules.update(ours)
    return mods


def this_modules():
    """The modules of the tputracer_torch that imports now, named as
    parent_modules names them."""
    from tputracer_torch import api, config, cuda_build, fit, scene
    from tputracer_torch.accel import (clustered, intersect_cuda, pairs,
                                       pairs_cuda, traverse_cuda)
    from tputracer_torch.integrators import bdpt, pt

    return SimpleNamespace(cl=clustered, tc=traverse_cuda, ic=intersect_cuda,
                           pairs=pairs, pc=pairs_cuda, api=api, config=config,
                           fit=fit, scene=scene, pt=pt, bdpt=bdpt,
                           cb=cuda_build)


def same_bits(a, b):
    """Whether two outputs (a tensor or a tuple of them) are equal bit for
    bit."""
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(
            x.view(torch.int32) if x.dtype == torch.float32 else x,
            y.view(torch.int32) if y.dtype == torch.float32 else y)
        for x, y in zip(a, b))


def in_turns(name, n_rays, old, new, same=same_bits, labels=("parent_", ""),
             **extra):
    """Both calls must give the same answer (``same(new(), old())``, bit
    for bit by default); then each is timed in turns (old, new, new, old),
    one call alone (``ms``, cuda_ms) and over 20 calls back to back
    (``device_ms``); prints an ``ab`` line, the old call's keys prefixed
    by labels[0] and the new one's by labels[1]."""
    out_n, out_o = new(), old()
    torch.cuda.synchronize()
    if not same(out_n, out_o):
        raise SystemExit(f"{name}: the two calls' outputs differ")
    res = {f"{p}{k}": [] for p in labels for k in ("ms", "device_ms")}
    for pre, fn in ((labels[0], old), (labels[1], new), (labels[1], new),
                    (labels[0], old)):
        res[f"{pre}ms"].append(cuda_ms(fn, 2, 5))
        res[f"{pre}device_ms"].append(device_ms(fn))
    print(json.dumps({"phase": "ab", "rays": name, "n_rays": n_rays,
                      **extra, **res}), flush=True)


def ab_intersect(old_ic):
    """The parent checkout's intersection kernel against this one on
    chip_smoke's phase-3 sets at 2^20 rays (random rays on boxes and
    spheres, closest and any hit; the closest-hit and shadow rays of
    bounce 2 of config 1's first chunk), each through its own wrapper on
    tables its own scene_args made once."""
    from tputracer_torch.accel import intersect_cuda as ic
    from tputracer_torch.scene import cornell_box

    scenes = {v: cornell_box(v, device="cuda") for v in ("boxes", "spheres")}
    for name, rays, _, any_hit, timed in intersect_sets():
        variant = name.split(",")[0]
        if (not timed or variant not in scenes
                or rays[0].shape[0] != N_RAYS):
            continue
        new_args = ic.scene_args(scenes[variant])
        old_args = old_ic.scene_args(scenes[variant])

        def new():
            return ic.fused_intersect_cuda(*rays, *new_args, any_hit=any_hit)

        def old():
            return old_ic.fused_intersect_cuda(*rays, *old_args,
                                               any_hit=any_hit)

        in_turns(name, N_RAYS, old, new, kernel="intersect",
                 mode="any" if any_hit else "closest")


def walk_sets(sc):
    """Config-3 ray sets as walk inputs (o, d, tmin, tmax, bt0 = tmax,
    bp0 = -1), closest hit: camera rays, random rays at 2^16 and 2^18."""
    bp = functools.partial(torch.full, fill_value=-1, dtype=torch.int32,
                           device="cuda")
    sets = [("camera", mesh_camera_rays(sc, seed=5)),
            ("random", room_rays(N_CHUNK, seed=6)),
            ("random 2^18", room_rays(4 * N_CHUNK, seed=9))]
    return [(name, (o, d, tmin, tmax, tmax.clone(), bp((o.shape[0],))))
            for name, (o, d, tmin, tmax, _) in sets]


def ab_traverse(old_cl, old_tc, sc, fallback_in):
    """The parent checkout's traversal kernel against this one, each
    through its own wrapper on tables its own traverse_args made once."""
    from tputracer_torch.accel import clustered as cl
    from tputracer_torch.accel import traverse_cuda as tc

    targs, old_targs = cl.traverse_args(sc), old_cl.traverse_args(sc)
    inputs = walk_sets(sc) + [("pair fallback", fallback_in)]
    for name, walk_in in inputs:
        def new():
            return tc.traverse_cuda(*walk_in, *targs, leaf=sc.leaf_size)

        def old():
            return old_tc.traverse_cuda(*walk_in, *old_targs,
                                        leaf=sc.leaf_size)

        in_turns(name, walk_in[0].shape[0], old, new, kernel="traverse")


def ab_pairs(old, sc):
    """The parent checkout's pair route against this one on walk_sets'
    rays, each through its own modules, in turns: expand, the slots' best
    (_slot_best: expand, bin, test and fold) and the whole route
    (_pair_traverse), bit for bit; then a trace line: the slots' best of
    each side and this side's pair-test call alone, per_call."""
    from tputracer_torch.accel import pairs
    from tputracer_torch.accel import pairs_cuda as pc

    cmin, cmax, v0, e1, e2, mask = pairs.pairs_args(sc)
    leaf, k = sc.leaf_size, pairs.K
    for name, (o, d, tmin, tmax, bt0, bp0) in walk_sets(sc):
        n = o.shape[0]
        in_turns(name, n,
                 lambda: old.pc.expand_cuda(o, d, tmin, tmax, cmin, cmax, k=k),
                 lambda: pc.expand_cuda(o, d, tmin, tmax, cmin, cmax, k=k),
                 kernel="expand")
        slots = {}
        for kernel, fn in (("slots", "_slot_best"),
                           ("route", "_pair_traverse")):
            runs = [functools.partial(getattr(mod, fn), sc, o, d, tmin, tmax,
                                      bt0, bp0, False)
                    for mod in (old.pairs, pairs)]
            in_turns(name, n, *runs, kernel=kernel)
            if kernel == "slots":
                slots = {"parent_slots": per_call(runs[0]),
                         "slots": per_call(runs[1])}
        cid, te, _ = pc.expand_cuda(o, d, tmin, tmax, cmin, cmax, k=k)
        new_in = (o, d, tmin, bt0, bp0, pairs.cluster_order(cid, sc.n_clusters),
                  cid, te, v0, e1, e2, mask)
        print(json.dumps({
            "phase": "trace", "rays": name, "n_rays": n, **slots,
            "pairtest": per_call(lambda: pc.pairtest_cuda(*new_in,
                                                          leaf=leaf))}),
            flush=True)


def ab_pairtest_glue(old, sc):
    """The parent's pair test, from before it took in its glue, on the
    pairs its glue gathers and folded as its glue folds, against this
    one's folded answer, in turns on walk_sets' rays; and a trace line for
    each side's call alone, per_call."""
    from tputracer_torch.accel import pairs
    from tputracer_torch.accel import pairs_cuda as pc

    cmin, cmax, v0, e1, e2, mask = pairs.pairs_args(sc)
    leaf, k = sc.leaf_size, pairs.K
    for name, (o, d, tmin, tmax, bt0, bp0) in walk_sets(sc):
        n = o.shape[0]
        cid, te, _ = pc.expand_cuda(o, d, tmin, tmax, cmin, cmax, k=k)
        sidx = pairs.cluster_order(cid, sc.n_clusters)
        ray = sidx // k
        old_in = (o[ray], d[ray], tmin[ray], cid.reshape(-1)[sidx],
                  te.reshape(-1)[sidx], bt0[ray], v0, e1, e2, mask)
        new_in = (o, d, tmin, bt0, bp0, sidx, cid, te, v0, e1, e2, mask)

        def folded(out):
            t_s = old.pairs._scatter(sidx, out[0]).reshape(n, k)
            p_s = old.pairs._scatter(sidx, out[1]).reshape(n, k)
            bt, bp = bt0, bp0
            for s in range(k):
                imp = t_s[:, s] < bt
                bt = torch.where(imp, t_s[:, s], bt)
                bp = torch.where(imp, p_s[:, s], bp)
            return bt, bp

        def old_test():
            return old.pc.pairtest_cuda(*old_in, leaf=leaf)

        def new_test():
            return pc.pairtest_cuda(*new_in, leaf=leaf)

        in_turns(name, n, old_test, new_test,
                 same=lambda new, old_out: same_bits(new, folded(old_out)),
                 kernel="pair test")
        print(json.dumps({"phase": "trace", "rays": name, "n_rays": n,
                          "parent_pairtest": per_call(old_test),
                          "pairtest": per_call(new_test)}), flush=True)


def fallback_orders(sc):
    """The pair route's fallback walk two ways on the same slots, in
    turns: every ray in its own order, the resolved ones at tmax = 0,
    which the walk skips (accel.pairs._pair_traverse); and the unresolved
    rays sorted first, with the gathers and scatters around the walk (the
    JAX package's glue).  The same bits."""
    from tputracer_torch.accel import clustered as cl
    from tputracer_torch.accel import pairs
    from tputracer_torch.accel import traverse_cuda as tc

    targs = cl.traverse_args(sc)
    for name, (o, d, tmin, tmax, bt0, bp0) in walk_sets(sc):
        best_t, best_p, resolved = pairs._slot_best(sc, o, d, tmin, tmax,
                                                    bt0, bp0, False)
        ftmax = torch.where(resolved, 0.0, tmax)

        def own_order():
            return tc.traverse(o, d, tmin, ftmax, best_t, best_p, *targs,
                               leaf=sc.leaf_size, any_hit=False)

        def unresolved_first():
            _, fidx = torch.sort(resolved.to(torch.int32), stable=True)
            ft, fp = tc.traverse(o[fidx], d[fidx], tmin[fidx], ftmax[fidx],
                                 best_t[fidx], best_p[fidx], *targs,
                                 leaf=sc.leaf_size, any_hit=False)
            return pairs._scatter(fidx, ft), pairs._scatter(fidx, fp)

        in_turns(name, o.shape[0], unresolved_first, own_order,
                 labels=("sorted_", "own_order_"), kernel="fallback",
                 unresolved=int((~resolved & (tmax > tmin)).sum()))


def sort_rays_effect(sc):
    """The closest-hit rays of every bounce of config 3's first chunk,
    recorded through trace_radiance's hook with cfg.sort_rays off and on
    (the same rays, permuted from bounce 1 on), through the traversal
    kernel and through the pair route: an ``ab`` line per bounce and
    route, unsorted against sorted in turns.  The answers must be the same
    multiset of bits."""
    from tputracer_torch.accel import clustered as cl
    from tputracer_torch.accel import intersect, pairs
    from tputracer_torch.accel import traverse_cuda as tc
    from tputracer_torch.config import RenderConfig
    from tputracer_torch.integrators.pt import trace_radiance

    cfg = RenderConfig(**MESH_CFG)
    recorded = {}
    for on in (False, True):
        calls = recorded[on] = []

        def isect(s, o, d, tmin, tmax, calls=calls):
            calls.append(tuple(x.clone(memory_format=torch.contiguous_format)
                               for x in (o, d, tmin, tmax)))
            return intersect(s, o, d, tmin, tmax)

        uid = torch.arange(cfg.chunk_size, dtype=torch.int64,
                           device=sc.device)
        trace_radiance(sc, uid, cfg.with_(sort_rays=on), intersect_fn=isect)

    def same_multiset(a, b):
        return all(torch.equal(torch.sort(x.view(torch.int32))[0],
                               torch.sort(y.view(torch.int32))[0])
                   for x, y in zip(a, b))

    targs = cl.traverse_args(sc)
    for b, (plain, sort) in enumerate(zip(recorded[False], recorded[True])):
        walks = []
        for o, d, tmin, tmax in (plain, sort):
            bp0 = torch.full(tmax.shape, -1, dtype=torch.int32,
                             device=tmax.device)
            walks.append((
                functools.partial(tc.traverse_cuda, o, d, tmin, tmax,
                                  tmax.clone(), bp0, *targs,
                                  leaf=sc.leaf_size),
                functools.partial(pairs._pair_traverse, sc, o, d, tmin, tmax,
                                  tmax.clone(), bp0, False)))
        live = int((plain[3] > plain[2]).sum())
        for i, kernel in enumerate(("traverse", "route")):
            in_turns(f"config 3 bounce {b}", plain[0].shape[0], walks[0][i],
                     walks[1][i], same=same_multiset,
                     labels=("unsorted_", "sorted_"), kernel=kernel,
                     bounce=b, live=live)


def sass_loops(so, function, marker):
    """The innermost loops (backward branches with no other inside) of the
    kernels in the library ``so`` whose mangled name holds ``function``
    that hold an instruction starting with ``marker``, from cuobjdump's
    SASS: for each, its instructions, its shared loads by width, and how
    many of each opcode (the mnemonic before its first dot)."""
    import re
    import subprocess

    tool = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                "cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    loops = []
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        if function not in part.split("\n", 1)[0]:
            continue
        ops = [(int(m.group(1), 16), re.sub(r"^@!?P\w+ ", "",
                                            m.group(2).strip()))
               for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", part)]
        ends = {}   # loop start: its last backward branch
        for addr, op in ops:
            m = re.search(r"BRA (?:\S+, )?0x([0-9a-f]+)", op)
            if m and int(m.group(1), 16) < addr:
                ends[int(m.group(1), 16)] = addr
        for lo, hi in sorted(ends.items()):
            if any(lo < start <= hi for start in ends):
                continue   # holds another loop
            body = [o for a, o in ops if lo <= a <= hi]
            if not any(o.startswith(marker) for o in body):
                continue
            loads, opcodes = {}, {}
            for o in body:
                name = o.split()[0]
                if name.startswith("LDS"):
                    loads[name] = loads.get(name, 0) + 1
                base = name.split(".")[0]
                opcodes[base] = opcodes.get(base, 0) + 1
            loops.append({"instructions": len(body), "shared_loads": loads,
                          "opcodes": dict(sorted(opcodes.items(),
                                                 key=lambda kv: -kv[1]))})
    return loops


def render_config1(old_ic):
    """Config 1's render (Cornell boxes, 512x512, 16 spp, 4 bounces) and,
    with the parent's intersect_cuda module ``old_ic``, the same render
    through the parent's kernel: untraced times in turns (parent, this,
    this, parent; three renders each time), then one traced render each;
    prints a render_profile line for each."""
    from tputracer_torch.config import RenderConfig
    from tputracer_torch.integrators.pt import render_pt
    from tputracer_torch.scene import cornell_box

    sc = cornell_box("boxes", device="cuda")
    cfg = RenderConfig(width=512, height=512, spp=16, max_bounces=4)
    runs = {"this": lambda: render_pt(sc, cfg)}
    order = ("this",)
    if old_ic is not None:
        runs["parent"] = lambda: render_pt(
            sc, cfg, intersect_fn=old_ic.intersect_fused,
            occluded_fn=old_ic.occluded_fused)
        order = ("parent", "this", "this", "parent")
    walls = {k: [] for k in runs}
    for fn in runs.values():
        fn()   # warm-up
    for k in order:
        walls[k] += [cuda_ms(runs[k], 0, 1) for _ in range(3)]
    for k, fn in runs.items():
        n, busy_ms, span_ms, top, b1_ms = profiled(fn, "fused_intersect")
        wall = statistics.median(walls[k])
        print(json.dumps({
            "phase": "render_profile", "config": 1, "kernel_of": k,
            "untraced_render_ms": wall, "untraced_all_ms": walls[k],
            "kernels": n, "busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall, "intersect_ms": b1_ms,
            "intersect_share": b1_ms / busy_ms, "traced_span_ms": span_ms,
            "top": top}), flush=True)


def render_config4():
    """Config 4's render (BDPT, Cornell caustic, 128x128, 8 spp, 4 bounces,
    chunks of 2^15): a trace line per group of the intersection kernel's
    calls in the first chunk (chip_smoke.bdpt_rays: per_call of the
    group's calls, so the kernel's own time a launch beside the host's
    time a group); then for config 4 and for the caustic scene at 512x512,
    16 spp, chunks of 2^18, untraced times (median of 3 after a warm-up)
    and one traced render, a render_profile line each."""
    from chip_smoke import BDPT_CFG, bdpt_rays
    from tputracer_torch.accel import intersect_cuda as ic
    from tputracer_torch.config import BdptConfig
    from tputracer_torch.integrators.bdpt import render_bdpt
    from tputracer_torch.scene import cornell_box

    sc = cornell_box("caustic", device="cuda")
    cfg = BdptConfig(**BDPT_CFG)
    args = ic.scene_args(sc)
    for group, calls in bdpt_rays(sc, cfg, cfg.chunk_size).items():
        any_hit = group in ("connections", "t=1")

        def kernel(calls=calls, any_hit=any_hit):
            for rays in calls:
                ic.fused_intersect_cuda(*rays, *args, any_hit=any_hit)

        print(json.dumps({"phase": "trace", "config": 4, "group": group,
                          "calls": len(calls), **per_call(kernel)}),
              flush=True)
    big = cfg.with_(width=512, height=512, spp=16, chunk_size=1 << 18)
    for size, c in (("128x128 8 spp, chunks of 2^15", cfg),
                    ("512x512 16 spp, chunks of 2^18", big)):
        render_bdpt(sc, c)   # warm-up
        walls = [cuda_ms(lambda: render_bdpt(sc, c), 0, 1) for _ in range(3)]
        n, busy_ms, span_ms, top, b1_ms = profiled(
            lambda: render_bdpt(sc, c), "fused_intersect")
        wall = statistics.median(walls)
        print(json.dumps({
            "phase": "render_profile", "config": 4, "size": size,
            "untraced_render_ms": wall, "untraced_all_ms": walls,
            "kernels": n, "busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall, "intersect_ms": b1_ms,
            "intersect_share": b1_ms / busy_ms, "traced_span_ms": span_ms,
            "top": top}), flush=True)


def op_device_ms(prof):
    """[(op, calls, device ms with its children, own device ms)] of a
    trace, from key_averages()."""
    rows = []
    for e in prof.key_averages():
        total = getattr(e, "device_time_total", None)
        own = getattr(e, "self_device_time_total", None)
        rows.append((e.key, e.count,
                     (e.cuda_time_total if total is None else total) / 1e3,
                     (e.self_cuda_time_total if own is None else own) / 1e3))
    return rows


# the backward of table[idx] (the parent's material and emitter lookups,
# and the lookups of tables above lookup.fetch's threshold): a sort-based
# accumulate of every lane into the table's rows; and lookup.fetch's
# one-hot matmul
LOOKUP_BACKWARD = "IndexBackward0"
ONE_HOT_BACKWARD = "_OneHotFetchBackward"


def lookup_backward_fields(ops):
    """The device ms (with children) and calls of the lookups' two
    backward ops in op_device_ms rows."""
    out = {}
    for key, op in (("lookup_backward", LOOKUP_BACKWARD),
                    ("one_hot_backward", ONE_HOT_BACKWARD)):
        out[key + "_ms"] = sum(t for k, _, t, _ in ops if k == op)
        out[key + "_calls"] = sum(c for k, c, _, _ in ops if k == op)
    return out


def fit_config5(old=None):
    """Config 5's fit step (chip_smoke.FIT_CFG: Cornell boxes, 128x128,
    4 spp, 3 bounces, rr_start=2, one chunk of 2^16 paths, from albedo x
    0.5 and emission x 2, Adam at 1e-2), without and with remat: the
    untraced step (median of 5 single steps, each between synchronizes,
    after a warm-up), then one step traced in two parts, each ended by a
    synchronize: the forward pass (render and loss) and the backward pass
    with Adam's update.  A fit_profile line each: kernels and busy time of
    each part, the intersection kernel's device time, the top kernels, the
    top ops by their own device time, the lookups' backward (IndexBackward0
    and lookup.fetch's one-hot backward, each with its children: device
    ms and calls) and its share of the backward's busy time, and the idle
    share 1 - (forward + backward busy) / untraced step.  With ``old``
    (parent_modules) the parent's step too, from its own modules: the
    untraced steps in turns (parent, this, this, parent; 5 each time),
    a line for each side."""
    import dataclasses

    from chip_smoke import FIT_CFG, FIT_LR, fit_start, wall_s

    sides = {"this": this_modules()}
    order = ("this",)
    if old is not None:
        sides["parent"] = old
        order = ("parent", "this", "this", "parent")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for remat in (False, True):
        runs = {}
        for side, m in sides.items():
            sc = m.scene.cornell_box("boxes", device="cuda")
            cfg = m.config.RenderConfig(**FIT_CFG).with_(remat=remat)
            with torch.no_grad():
                target, _ = m.pt.render_pt(sc, cfg)
            p = {k: v.detach().clone().requires_grad_()
                 for k, v in fit_start(sc).items()}
            opt = m.fit._adam(list(p.values()), FIT_LR)

            # fit._fit_step_single, spelled out: fit.py imports render_pt
            # when it is called, which for the parent's fit would be this
            # checkout's
            def step(m=m, sc=sc, p=p, target=target, cfg=cfg, opt=opt):
                m.fit.chain_steps(
                    lambda s, q, t: m.api._loss_and_grads(
                        m.pt.render_pt, s, q, t, cfg), sc, p, target, opt, 1)

            step()   # warm-up
            runs[side] = (m, sc, p, target, cfg, opt, step)
        walls = {k: [] for k in sides}
        for side in order:
            walls[side] += wall_s(runs[side][-1], 5)
        for side, (m, sc, p, target, cfg, opt, _) in runs.items():
            with torch.profiler.profile(activities=acts) as fwd:
                img, _ = m.pt.render_pt(dataclasses.replace(sc, **p), cfg)
                loss = m.api._loss_l2(img, target)
                torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as bwd:
                grads = torch.autograd.grad(loss, list(p.values()))
                for v, g in zip(p.values(), grads):
                    v.grad = g
                opt.step()
                opt.zero_grad(set_to_none=True)
                m.fit._project(p)
                torch.cuda.synchronize()
            parts = {}
            for name, prof in (("forward", fwd), ("backward", bwd)):
                n, busy_ms, span_ms, top, b1_ms = busy(prof,
                                                       "fused_intersect")
                ops = op_device_ms(prof)
                parts[name] = {
                    "kernels": n, "busy_ms": busy_ms,
                    "traced_span_ms": span_ms, "intersect_ms": b1_ms,
                    "top": top,
                    "top_ops": [(k[:50], c, round(t, 4), round(o, 4))
                                for k, c, t, o in
                                sorted(ops, key=lambda r: -r[3])[:10]],
                    **lookup_backward_fields(ops)}
            wall = statistics.median(walls[side]) * 1e3
            total_busy = (parts["forward"]["busy_ms"]
                          + parts["backward"]["busy_ms"])
            bwd_part = parts["backward"]
            print(json.dumps({
                "phase": "fit_profile", "config": 5, "remat": remat,
                "code_of": side, "untraced_step_ms": wall,
                "untraced_all_ms": [w * 1e3 for w in walls[side]],
                "kernels": parts["forward"]["kernels"] + bwd_part["kernels"],
                "busy_ms": total_busy, "idle_share": 1.0 - total_busy / wall,
                "lookups_backward_share_of_backward":
                    (bwd_part["lookup_backward_ms"]
                     + bwd_part["one_hot_backward_ms"])
                    / bwd_part["busy_ms"],
                **parts}), flush=True)


def lookup_backward_costs():
    """The backward of one material lookup alone (Cornell boxes' (6, 3)
    albedo table) with the material ids of config 5's camera hits
    (128x128 4 spp: 2^16 lanes; and 512x512 4 spp: 2^20) in five ways:
    table[idx]'s own (IndexBackward0, the parent's lookups), lookup.fetch
    (the one-hot matmul in blocks, through autograd), an index_add_ into
    zeros (atomics), a one-hot matmul and a masked broadcast product
    summed over the lanes.  A lookup_backward line each: ms (cuda_ms),
    whether three runs give the same bits, the largest error over the
    largest entry against table[idx]'s, and the bound: each lane's id (4
    bytes) and gradient row (12) read once, the table written once, over
    3.35 TB/s."""
    import torch.nn.functional as F

    from chip_smoke import BIG, FIT_CFG, PEAK_BYTES
    from tputracer_torch import lookup
    from tputracer_torch.accel import intersect
    from tputracer_torch.config import RenderConfig
    from tputracer_torch.integrators.pt import camera_rays
    from tputracer_torch.scene import cornell_box

    sc = cornell_box("boxes", device="cuda")
    table = sc.mat_albedo.detach().clone().requires_grad_()
    M = table.shape[0]
    rows = torch.arange(M, device="cuda")
    for size in (128, 512):
        cfg = RenderConfig(**dict(FIT_CFG, width=size, height=size))
        n = size * size * cfg.spp
        uid = torch.arange(n, dtype=torch.int64, device="cuda")
        o, d = camera_rays(sc, uid, cfg)
        zeros = torch.zeros((n,), device="cuda")
        idx = intersect(sc, o, d, zeros, torch.full_like(zeros, BIG)).mat
        grad = torch.rand((n, 3), device="cuda",
                          generator=torch.Generator("cuda").manual_seed(0))
        ways = {
            "table[idx] (IndexBackward0)": lambda: torch.autograd.grad(
                table[idx.long()], [table], grad)[0],
            "lookup.fetch (one-hot matmul in blocks)":
                lambda: torch.autograd.grad(lookup.fetch(table, idx),
                                            [table], grad)[0],
            "index_add_": lambda: torch.zeros_like(table).index_add_(
                0, idx, grad),
            "one-hot matmul": lambda: F.one_hot(idx.long(), M).to(
                grad.dtype).T @ grad,
            "masked sum": lambda: ((idx[:, None] == rows)[:, :, None]
                                   * grad[:, None, :]).sum(0),
        }
        ref = ways["table[idx] (IndexBackward0)"]()
        for name, fn in ways.items():
            outs = [fn() for _ in range(3)]
            print(json.dumps({
                "phase": "lookup_backward", "lanes": n, "way": name,
                "ms": cuda_ms(fn, 2, 5),
                "repeats_bits": all(torch.equal(x, outs[0]) for x in outs),
                "max_rel_err": float((outs[0] - ref).abs().max()
                                     / ref.abs().max()),
                "bound_ms": (n * 16 + M * 12) / PEAK_BYTES * 1e3,
                "rows_hit": torch.bincount(idx.long(), minlength=M).tolist()}),
                flush=True)


def render_bits(old):
    """Configs 1-4 rendered by this checkout and by the parent's modules
    (``old``, parent_modules) in one process: a render_bits line each
    with the two images and ray counts equal bit for bit or not (BDPT:
    the per-path radiance L_own of trace_bdpt_rows and its ray counts
    bit for bit, the image, whose splat index_add_ sums in no fixed order
    on the card, by its largest difference), each side's intersection and
    traversal launches in one render, and each side's device kernels in
    one traced render (after an untraced one).  Config 1: boxes 512x512
    16 spp 4 bounces; 2: spheres 256x256 64 spp 6 bounces rr_start=3; 3:
    mesh_scene(subdiv=6) at MESH_CFG; 4: BDPT on caustic at BDPT_CFG."""
    from chip_smoke import BDPT_CFG, SPHERES_CFG

    configs = {
        1: ("pt", lambda m: m.scene.cornell_box("boxes", device="cuda"),
            dict(width=512, height=512, spp=16, max_bounces=4)),
        2: ("pt", lambda m: m.scene.cornell_box("spheres", device="cuda"),
            SPHERES_CFG),
        3: ("pt", lambda m: m.scene.mesh_scene(subdiv=6, device="cuda"),
            MESH_CFG),
        4: ("bdpt", lambda m: m.scene.cornell_box("caustic", device="cuda"),
            BDPT_CFG),
    }
    sides = {"parent": old, "this": this_modules()}
    for config, (kind, build, kw) in configs.items():
        out = {}
        for side, m in sides.items():
            sc = build(m)
            if kind == "pt":
                cfg = m.config.RenderConfig(**kw)
                run = functools.partial(m.pt.render_pt, sc, cfg)
            else:
                cfg = m.config.BdptConfig(**kw)
                run = functools.partial(m.bdpt.render_bdpt, sc, cfg)
            m.cb.LAUNCHES.clear()
            img, stats = run()
            torch.cuda.synchronize()
            launches = {"fused_intersect":
                        m.cb.LAUNCHES["fused_intersect_kernel"],
                        "traverse": m.cb.LAUNCHES["traverse_kernel"]}
            bits = img
            if kind == "bdpt":
                n = cfg.width * cfg.height * cfg.spp
                bits, _, stats = m.bdpt.trace_bdpt_rows(
                    sc, torch.arange(n, device="cuda"), cfg)
            kernels = profiled(run)[0]
            out[side] = (img, bits, stats, launches, kernels)
        (img_p, bits_p, st_p, *_), (img_t, bits_t, st_t, *_) = (
            out["parent"], out["this"])
        print(json.dumps({
            "phase": "render_bits", "config": config,
            "compared": "L_own" if kind == "bdpt" else "image",
            "bitwise": torch.equal(bits_p, bits_t),
            "ray_counts_bitwise": all(torch.equal(st_p[k], st_t[k])
                                      for k in ("rays_closest",
                                                "rays_shadow")),
            "image_max_abs_err": float((img_p - img_t).abs().max()),
            "launches": {k: v[3] for k, v in out.items()},
            "kernels": {k: v[4] for k, v in out.items()}}), flush=True)


def lookups(parent):
    """The lookups' module against the checkout at ``parent``: render_bits,
    fit_config5 in turns with the parent's, and lookup_backward_costs."""
    old = parent_modules(parent)
    render_bits(old)
    fit_config5(old)
    lookup_backward_costs()


def rank_dist_config3(mesh, refs):
    """One rank of dist_config3 (chip_smoke.run_world's task)."""
    import torch.distributed as dist

    from chip_smoke import _barrier_s
    from tputracer_torch.config import RenderConfig
    from tputracer_torch.dist import render_tiled
    from tputracer_torch.scene import mesh_scene

    scene = mesh_scene(subdiv=6, device="cpu")
    cfg = RenderConfig(**MESH_CFG)

    def run():
        render_tiled(scene, cfg, mesh, device="cuda")

    run()   # warm-up
    walls = _barrier_s(run, 3)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    dist.barrier()
    if mesh.rank != 0:
        run()
        torch.cuda.synchronize()
        return {"rank": mesh.rank, "untraced_render_s_all": walls}
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    n, busy_ms, span_ms, top, walk_ms = busy(prof)
    hops = [e for e in prof.events() if e.name == "tputracer.dist.ring_hop"
            and e.device_type == torch.autograd.DeviceType.CPU]
    copies = sum((e.time_range.end - e.time_range.start) / 1e3
                 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "Memcpy" in e.name)
    wall = statistics.median(walls) * 1e3
    return {"rank": 0, "untraced_render_ms": wall,
            "untraced_render_s_all": walls, "kernels": n,
            "busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall,
            "traverse_ms": walk_ms, "traverse_share": walk_ms / busy_ms,
            "hops": len(hops),
            "hop_host_ms": sum((e.time_range.end - e.time_range.start) / 1e3
                               for e in hops),
            "copy_device_ms": copies, "traced_span_ms": span_ms, "top": top}


def rank_dist_fit5(mesh, refs):
    """One rank of dist_fit5 (chip_smoke.run_world's task)."""
    import torch.distributed as dist

    from chip_smoke import FIT_CFG, FIT_K, FIT_LR, _barrier_s, fit_start
    from tputracer_torch import fit as tfit
    from tputracer_torch.config import RenderConfig
    from tputracer_torch.dist import fit_chain_sharded, fit_step_sharded
    from tputracer_torch.integrators.pt import render_pt
    from tputracer_torch.scene import cornell_box

    sc = cornell_box("boxes", device="cuda")
    cfg = RenderConfig(**FIT_CFG)
    with torch.no_grad():
        target, _ = render_pt(sc, cfg)
    p = {k: v.detach().clone().requires_grad_()
         for k, v in fit_start(sc).items()}
    opt = tfit._adam(list(p.values()), FIT_LR)

    def step():
        fit_chain_sharded(sc, p, target, cfg, mesh, opt, 1)

    # phase 15's order: one step without the optimizer, then fit(mesh=)
    # twice, FIT_K steps in one chain each
    fit_step_sharded(sc, fit_start(sc), target, cfg, mesh)
    fit_s = _barrier_s(lambda: tfit.fit(
        sc, target, cfg=cfg, steps=FIT_K, learning_rate=FIT_LR,
        init=fit_start(sc), log_every=0, steps_per_dispatch=FIT_K,
        mesh=mesh), 2)
    step()   # warm-up
    walls = _barrier_s(step, 5)
    dist.barrier()
    if mesh.rank != 0:
        step()
        torch.cuda.synchronize()
        return {"rank": mesh.rank, "untraced_step_s_all": walls,
                "fit_steps_per_s": [FIT_K / s for s in fit_s]}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step()
        torch.cuda.synchronize()
    n, busy_ms, span_ms, top, b1_ms = busy(prof, "fused_intersect")
    ops = op_device_ms(prof)
    wall = statistics.median(walls) * 1e3
    return {"rank": 0, "untraced_step_ms": wall,
            "untraced_step_s_all": walls,
            "fit_steps_per_s": [FIT_K / s for s in fit_s],
            "kernels": n, "busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall, "intersect_ms": b1_ms,
            **lookup_backward_fields(ops),
            "traced_span_ms": span_ms, "top": top,
            "top_ops": [(k[:50], c, round(t, 4), round(o, 4)) for k, c, t, o
                        in sorted(ops, key=lambda r: -r[3])[:8]]}


def dist_fit5():
    """Config 5's DP fit step (dist.fit_chain_sharded, one step) in gloo
    worlds of 1 and 2 ranks on the card, rank 0 traced: a dist_profile
    line each (steps/s of two fit(mesh=) calls of FIT_K steps in one
    chain after one fit_step_sharded, as phase 15 calls them; an untraced
    step from a barrier to a synchronize, median of 5 after a warm-up;
    one step traced: kernels, busy, idle, the lookups' backward)."""
    import tempfile

    from chip_smoke import run_world

    for world in (1, 2):
        with tempfile.TemporaryDirectory() as tmp:
            ranks = run_world("chip_profile.rank_dist_fit5", world, tmp,
                              "gloo")
        print(json.dumps({"phase": "dist_profile", "config": 5,
                          "ranks": world, "backend": "gloo, one card",
                          **ranks[0]}), flush=True)


def first_step_costs():
    """A process's first optimizer step on the card against its second:
    run in a fresh process (``python3 -c "import chip_profile as c;
    c.first_step_costs()"``), it prints whether ``torch._dynamo`` was
    loaded before the first step and after it, and the seconds of each
    of two Adam steps (chip_smoke's fit optimizer) on a CUDA tensor,
    each ended by a synchronize."""
    from tputracer_torch import fit as tfit

    p = torch.zeros(3, device="cuda", requires_grad=True)
    opt = tfit._adam([p], 1e-2)
    torch.cuda.synchronize()
    before = "torch._dynamo" in sys.modules
    secs = []
    for _ in range(2):
        p.grad = torch.ones_like(p)
        t0 = time.perf_counter()
        opt.step()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    print(json.dumps({"phase": "first_step", "dynamo_loaded_before": before,
                      "dynamo_loaded_after": "torch._dynamo" in sys.modules,
                      "adam_step_s": secs}), flush=True)


def dist_config3():
    """Config 3 tiled over two gloo ranks sharing the card, rank 0 traced:
    a dist_profile line (see the module's docstring)."""
    import tempfile

    from chip_smoke import run_world

    with tempfile.TemporaryDirectory() as tmp:
        ranks = run_world("chip_profile.rank_dist_config3", 2, tmp, "gloo")
    print(json.dumps({"phase": "dist_profile", "config": 3, "ranks": 2,
                      "backend": "gloo, one card", **ranks[0],
                      "rank1_untraced_render_s_all":
                          ranks[1]["untraced_render_s_all"]}), flush=True)


def span_costs(n=100_000, reps=5, units=6, turns=3):
    """The cost of the port's spans (tputracer_torch.trace).  Off: with no
    profiler running, ``n`` spans each timed on their own, the median
    less the median of an empty call timed alike, ``reps`` times (a
    span_off_cost line each).  On: under torch.profiler, ``units`` frames
    of config 1 and of config 3 through their graphs and ``units`` chains
    of FIT_K config-5 fit steps, each timed from its start to its result
    on the host, with the spans' ranges and without them (the spans then
    record as if no profiler ran), in turns, ``turns`` times each (a
    span_on_cost line each: the median unit's ms of each side)."""
    from chip_smoke import FIT_CFG, FIT_K, FIT_LR, fit_start
    from tputracer_torch import api, fit, graphs, trace
    from tputracer_torch.config import RenderConfig
    from tputracer_torch.scene import cornell_box, mesh_scene

    clock = time.perf_counter_ns

    def timed(body):
        ts = []
        for _ in range(n):
            t = clock()
            body()
            ts.append(clock() - t)
        return statistics.median(ts)

    def one_span():
        with trace.span("span_cost"):
            pass

    def empty():
        pass

    for rep in range(reps):
        base = timed(empty)
        per = timed(one_span)
        print(json.dumps({"phase": "span_off_cost", "rep": rep, "n": n,
                          "span_ns": per - base, "timer_ns": base}),
              flush=True)
        trace.reset()

    boxes = cornell_box("boxes", device="cuda")
    box_cfg = RenderConfig(width=512, height=512, spp=16, max_bounces=4,
                           rr_start=3, chunk_size=1 << 20)
    mesh = mesh_scene(subdiv=6, device="cuda")
    mesh_cfg = RenderConfig(**MESH_CFG)
    fit_cfg = RenderConfig(**FIT_CFG)
    with torch.no_grad():
        target = api.render(boxes, fit_cfg)[0].clone()
    params = {k: v.clone().requires_grad_()
              for k, v in fit_start(boxes).items()}
    opt = fit._adam(list(params.values()), FIT_LR)
    cases = {
        "config 1 frame": lambda: api.render(boxes, box_cfg)[0].cpu(),
        "config 3 frame": lambda: api.render(mesh, mesh_cfg)[0].cpu(),
        "config 5 chain": lambda: fit._fit_chain_single(
            boxes, params, target, fit_cfg, opt, FIT_K).tolist()}
    real, off = trace._profiler, SimpleNamespace(_is_profiler_enabled=False)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for name, unit in cases.items():
        for _ in range(3):   # eager, the capture, a replay; the fit warm
            unit()
        sides = {"ranges": [], "no_ranges": []}
        try:
            for _ in range(turns):
                for side in sides:
                    trace._profiler = real if side == "ranges" else off
                    with torch.profiler.profile(activities=acts):
                        for _ in range(units):
                            t = time.perf_counter()
                            unit()
                            sides[side].append(1e3 * (time.perf_counter()
                                                      - t))
        finally:
            trace._profiler = real
        ms = {k: statistics.median(v) for k, v in sides.items()}
        print(json.dumps({"phase": "span_on_cost", "case": name,
                          "units": units * turns, "median_ms": ms,
                          "ranges_over_none": ms["ranges"]
                          / ms["no_ranges"] - 1.0, "all_ms": sides}),
              flush=True)
    graphs.clear()


def graph_profiles():
    """Configs 1, 3 and 4 graphed and eager, in turns, then traced: a
    graph_profile line for each render and dispatch (see the module's
    docstring).  Raises if a graphed render's trace holds fewer device
    events than its graph has kernel nodes, or other launches of the
    port's kernels than its graph holds."""
    from chip_smoke import BDPT_CFG
    from tputracer_torch import api, cuda_build, graphs
    from tputracer_torch.config import BdptConfig, RenderConfig
    from tputracer_torch.integrators import bdpt
    from tputracer_torch.integrators.pt import render_pt
    from tputracer_torch.scene import cornell_box, mesh_scene

    os.environ.pop("TPUTRACER_PAIRS", None)
    cases = [
        ("config 1", cornell_box("boxes", device="cuda"),
         RenderConfig(width=512, height=512, spp=16, max_bounces=4),
         api.render, render_pt, "fused_intersect"),
        ("config 3", mesh_scene(subdiv=6, device="cuda"),
         RenderConfig(**MESH_CFG), api.render, render_pt, "traverse_kernel"),
        ("config 4", cornell_box("caustic", device="cuda"),
         BdptConfig(**BDPT_CFG), api.render_bdpt, bdpt.render_bdpt,
         "fused_intersect"),
    ]
    for name, sc, cfg, graphed, eager, kernel in cases:
        graphs.clear()
        runs = {"graphed": functools.partial(graphed, sc, cfg),
                "eager": functools.partial(eager, sc, cfg)}
        for fn in (runs["graphed"], *runs.values()):
            fn()   # eager, then the capture; the eager warm-up
        walls = {k: [] for k in runs}
        for _ in range(3):   # in turns, so drift hits both alike
            for k, fn in runs.items():
                walls[k].append(cuda_ms(fn, 0, 1))
        census = graphs.graphs()[0].census
        kernel_nodes, nodes = census["kernel_nodes"], census["nodes"]
        for k, fn in runs.items():
            prof = traced(fn)
            n, busy_ms, span_ms, top, kernel_ms = busy(prof, kernel)
            ours = dict.fromkeys(cuda_build.kernels(), 0)
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    if (name_k := graphs.kernel_of(e.name)) is not None:
                        ours[name_k] += 1
            wall = statistics.median(walls[k])
            line = {"phase": "graph_profile", "config": name, "dispatch": k,
                    "untraced_render_ms": wall, "untraced_all_ms": walls[k],
                    "device_events": n, "busy_ms": busy_ms,
                    "idle_share": 1.0 - busy_ms / wall,
                    "kernel_ms": kernel_ms, "kernel_share": kernel_ms / busy_ms,
                    "traced_span_ms": span_ms, "top": top}
            line["traced_launches"] = ours
            if k == "graphed":
                line.update(graph_kernel_nodes=kernel_nodes,
                            graph_nodes=nodes,
                            graph_launches={q: census[q]
                                            for q in cuda_build.kernels()})
                line["trace_complete"] = ours == line["graph_launches"]
            print(json.dumps(line), flush=True)
            if k == "graphed" and n < kernel_nodes:
                raise SystemExit(
                    f"{name}: the trace of a graphed render holds {n} device "
                    f"events, its graph {kernel_nodes} kernels")
            if k == "graphed" and any(
                    ours[q] > census[q] for q in cuda_build.kernels()):
                raise SystemExit(
                    f"{name}: the trace of a graphed render launched {ours}, "
                    f"its graph holds {line['graph_launches']}")
        graphs.clear()


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", metavar="DIR",
                        help="an earlier checkout whose intersection, "
                             "traversal and pair kernels to time beside "
                             "this one")
    parser.add_argument("--settled", action="store_true",
                        help="also re-run the fallback-order and (with "
                             "--parent) the pair-test glue experiments")
    parser.add_argument("--sass", action="store_true",
                        help="only print the kernels' inner loops from "
                             "their SASS")
    parser.add_argument("what", nargs="?", choices=["graphs"],
                        help="graphs: only profile the compiled entry "
                             "points (CUDA graphs) against eager renders")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script profiles the card")
    from tputracer_torch.accel import clustered as cl
    from tputracer_torch.accel import intersect_cuda as ic
    from tputracer_torch.accel import pairs
    from tputracer_torch.accel import traverse_cuda as tc
    from tputracer_torch.config import RenderConfig
    from tputracer_torch.cuda_build import library_path
    from tputracer_torch.integrators.pt import render_pt
    from tputracer_torch.scene import mesh_scene

    card = card_line()
    print(card, flush=True)
    if opts.what == "graphs":
        graph_profiles()
        return
    if opts.sass:
        from tputracer_torch.accel import pairs_cuda as pc

        ic.LIB.load()
        pc.LIB.load()
        for source, function, marker in (
                ("intersect.cu", "fused_intersect", "MUFU.RCP"),
                ("pairs.cu", "expand_kernelILi8ELi5E", "FMNMX"),
                ("pairs.cu", "pairtest_kernel", "MUFU.RCP")):
            print(json.dumps({
                "phase": "sass", "source": f"csrc/{source}",
                "kernel": function, "loops_with": marker,
                "loops": sass_loops(library_path(source), function, marker)}),
                flush=True)
        return
    old = None
    if opts.parent:
        old = parent_modules(opts.parent)
        if old.ic is ic:
            raise SystemExit(f"{opts.parent}: imported this checkout, not "
                             f"the parent")
    render_config1(old and old.ic)
    render_config4()
    fit_config5(old)
    lookup_backward_costs()
    if old is not None:
        render_bits(old)
        ab_intersect(old.ic)

    sc = mesh_scene(subdiv=6, device="cuda")
    o, d, tmin, tmax, _ = room_rays(N_CHUNK, seed=6)
    bt0 = tmax.clone()
    bp0 = torch.full((N_CHUNK,), -1, dtype=torch.int32, device="cuda")
    targs = cl.traverse_args(sc)

    def route():
        return pairs._pair_traverse(sc, o, d, tmin, tmax, bt0, bp0, False)

    def walk():
        return tc.traverse_cuda(o, d, tmin, tmax, bt0, bp0, *targs,
                                leaf=sc.leaf_size)

    f_in, unresolved = fallback_input(sc, o, d, tmin, tmax)
    if old is not None:
        ab_traverse(old.cl, old.tc, sc, f_in)
        ab_pairs(old, sc)
    if opts.settled:
        fallback_orders(sc)
        if old is not None:
            ab_pairtest_glue(old, sc)
    sort_rays_effect(sc)

    def fallback():
        return tc.traverse_cuda(*f_in, *targs, leaf=sc.leaf_size)

    print(json.dumps({
        "phase": "call", "n_rays": N_CHUNK, "card": card,
        "unresolved_rays": unresolved,
        "route_ms": cuda_ms(route, 2, 5), "traverse_ms": cuda_ms(walk, 2, 5),
        "fallback_traverse_ms": cuda_ms(fallback, 2, 5),
        "slots_ms": cuda_ms(lambda: pairs._slot_best(
            sc, o, d, tmin, tmax, bt0, bp0, False), 2, 5)}), flush=True)
    n, busy_ms, span_ms, top, _ = profiled(route)
    print(json.dumps({"phase": "call_profile", "what": "pair route, 2^16",
                      "kernels": n, "busy_ms": busy_ms, "span_ms": span_ms,
                      "top": top}), flush=True)

    cfg = RenderConfig(**MESH_CFG)
    before = os.environ.pop("TPUTRACER_PAIRS", None)
    try:
        for route_name in ("default", "pairs"):
            if route_name == "pairs":
                os.environ["TPUTRACER_PAIRS"] = "1"
            wall = statistics.median([cuda_ms(lambda: render_pt(sc, cfg), 1,
                                              1) for _ in range(3)])
            n, busy_ms, span_ms, top, walk_ms = profiled(
                lambda: render_pt(sc, cfg))
            print(json.dumps({
                "phase": "render_profile", "route": route_name,
                "untraced_render_ms": wall, "kernels": n, "busy_ms": busy_ms,
                "idle_share": 1.0 - busy_ms / wall,
                "traverse_ms": walk_ms, "traverse_share": walk_ms / busy_ms,
                "traced_span_ms": span_ms, "top": top}), flush=True)
    finally:
        os.environ.pop("TPUTRACER_PAIRS", None)
        if before is not None:
            os.environ["TPUTRACER_PAIRS"] = before


if __name__ == "__main__":
    main()
