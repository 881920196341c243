#!/usr/bin/env python3
"""Where the render paths' time goes on one CUDA card.

    python3 chip_profile.py [--parent DIR]
    python3 chip_profile.py --sass

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

Config 3, on the 102,410-triangle mesh of BASELINE config 3
(mesh_scene(subdiv=6)) and 2^16 random rays from inside its room
(chip_smoke.room_rays):

  * call: the whole pair route (accel.pairs._pair_traverse), the traversal
    kernel alone, and the traversal kernel on the route's fallback input
    (the rays sorted unresolved-first, resolved ones with tmax = 0), each
    timed with CUDA events (median of 5 after 2 warm-ups);
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
intersection and traversal wrappers (accel.intersect_cuda with its own
scene_args, accel.traverse_cuda with its own accel.clustered.
traverse_args), which build that checkout's kernels, and:

  * renders config 1 through the parent's intersection kernel too (its
    intersect_fused and occluded_fused as render_pt's hooks), the untraced
    renders in turns (parent, this, this, parent), and profiles it;
  * prints an ``ab`` line per ray set: for the intersection kernel,
    chip_smoke's phase-3 sets at 2^20 rays (random rays on boxes and
    spheres, closest and any hit; the closest-hit and shadow rays of
    bounce 2 of config 1's first chunk); for the traversal kernel,
    config-3 camera rays, random rays at 2^16 and 2^18, closest hit, and
    the pair route's fallback input.  The two kernels' outputs must be
    equal bit for bit, and each is timed in turns (parent, this, this,
    parent), per single call (``ms``, cuda_ms) and on the card over 20
    calls back to back (``device_ms``).

With ``--sass`` it only builds this checkout's intersection kernel and
prints a sass line: the kernel's innermost loops that hold a division
(its triangle loops), from cuobjdump -sass of the built library, with
their instructions and shared loads by width, i.e. per triangle tested.

Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import sys
from pathlib import Path

import torch

from chip_smoke import (MESH_CFG, N_CHUNK, N_RAYS, card_line, cuda_ms,
                        device_ms, fallback_input, intersect_sets,
                        mesh_camera_rays, room_rays)


def busy(prof, kernel="traverse_kernel"):
    """(kernels, busy ms, span ms, top kernels by device ms, device ms of
    the kernels whose name holds ``kernel``) of a trace."""
    ks = sorted((e.time_range.start, e.time_range.end, e.name)
                for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA)
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


def profiled(fn, kernel="traverse_kernel"):
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return busy(prof, kernel)


def parent_modules(root):
    """The accel modules of the checkout at ``root``: (clustered,
    traverse_cuda, intersect_cuda).  Its package is imported under its own
    name while this one's modules are set aside, and its two kernels are
    built (into its own csrc/build) before they are put back."""
    name = "tputracer_torch"
    ours = {k: sys.modules.pop(k) for k in list(sys.modules)
            if k == name or k.startswith(name + ".")}
    sys.path.insert(0, str(Path(root).resolve()))
    try:
        from tputracer_torch.accel import (clustered, intersect_cuda,
                                           traverse_cuda)
        traverse_cuda.load_kernel()
        intersect_cuda.load_kernel()
    finally:
        sys.path.pop(0)
        for k in [k for k in sys.modules
                  if k == name or k.startswith(name + ".")]:
            del sys.modules[k]
        sys.modules.update(ours)
    return clustered, traverse_cuda, intersect_cuda


def in_turns(name, n_rays, old, new, **extra):
    """Both calls must give the same bits; then each is timed in turns
    (parent, this, this, parent), one call alone (``ms``, cuda_ms) and over
    20 calls back to back (``device_ms``); prints an ``ab`` line."""
    (t_n, p_n), (t_o, p_o) = new(), old()
    torch.cuda.synchronize()
    if not (torch.equal(t_n.view(torch.int32), t_o.view(torch.int32))
            and torch.equal(p_n, p_o)):
        raise SystemExit(f"{name}: the parent kernel's output differs")
    res = {"parent_ms": [], "ms": [], "parent_device_ms": [],
           "device_ms": []}
    for pre, fn in (("parent_", old), ("", new), ("", new), ("parent_", old)):
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


def ab_traverse(old_cl, old_tc, sc, fallback_in):
    """The parent checkout's traversal kernel against this one, each
    through its own wrapper on tables its own traverse_args made once."""
    from tputracer_torch.accel import clustered as cl
    from tputracer_torch.accel import traverse_cuda as tc

    targs, old_targs = cl.traverse_args(sc), old_cl.traverse_args(sc)
    bp = functools.partial(torch.full, fill_value=-1, dtype=torch.int32,
                           device="cuda")
    sets = [("camera", mesh_camera_rays(sc, seed=5)),
            ("random", room_rays(N_CHUNK, seed=6)),
            ("random 2^18", room_rays(4 * N_CHUNK, seed=9))]
    inputs = [(name, (o, d, tmin, tmax, tmax.clone(), bp((o.shape[0],))))
              for name, (o, d, tmin, tmax, _) in sets]
    inputs.append(("pair fallback", fallback_in))
    for name, walk_in in inputs:
        def new():
            return tc.traverse_cuda(*walk_in, *targs, leaf=sc.leaf_size)

        def old():
            return old_tc.traverse_cuda(*walk_in, *old_targs,
                                        leaf=sc.leaf_size)

        in_turns(name, walk_in[0].shape[0], old, new, kernel="traverse")


def sass_loops(so):
    """The innermost loops (backward branches with no other inside) of the
    library ``so`` that hold a division (MUFU.RCP), from cuobjdump's SASS:
    for each, its instructions and its shared loads by width.  In the
    intersection kernel these are the triangle loops."""
    import re
    import subprocess

    tool = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                "cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    ops = [(int(m.group(1), 16), m.group(2).strip()) for m in re.finditer(
        r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", sass)]
    ends = {}   # loop start: its last backward branch
    for addr, op in ops:
        m = re.search(r"BRA (?:\S+, )?0x([0-9a-f]+)", op)
        if m and int(m.group(1), 16) < addr:
            ends[int(m.group(1), 16)] = addr
    loops = []
    for lo, hi in sorted(ends.items()):
        if any(lo < start <= hi for start in ends):
            continue   # holds another loop
        body = [o for a, o in ops if lo <= a <= hi]
        if not any(re.match(r"(?:@!?P\d )?MUFU\.RCP", o) for o in body):
            continue
        loads = {}
        for o in body:
            w = re.match(r"(?:@!?P\d )?(LDS(?:\.\w+)?)\b", o)
            if w:
                loads[w.group(1)] = loads.get(w.group(1), 0) + 1
        loops.append({"instructions": len(body), "shared_loads": loads})
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


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", metavar="DIR",
                        help="an earlier checkout whose intersection and "
                             "traversal kernels to time beside this one")
    parser.add_argument("--sass", action="store_true",
                        help="only print the intersection kernel's triangle "
                             "loops from its SASS")
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
    if opts.sass:
        ic.load_kernel()
        print(json.dumps({"phase": "sass", "source": "csrc/intersect.cu",
                          "division_loops": sass_loops(
                              library_path("intersect.cu"))}), flush=True)
        return
    old_cl = old_tc = old_ic = None
    if opts.parent:
        old_cl, old_tc, old_ic = parent_modules(opts.parent)
        if old_ic is ic:
            raise SystemExit(f"{opts.parent}: imported this checkout, not "
                             f"the parent")
    render_config1(old_ic)
    if old_ic is not None:
        ab_intersect(old_ic)

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
    if old_tc is not None:
        ab_traverse(old_cl, old_tc, sc, f_in)

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
