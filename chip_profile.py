#!/usr/bin/env python3
"""Where the pair route's time goes on one CUDA card.

    python3 chip_profile.py

Run from the root of a checkout, after (or without) chip_smoke.py.  On the
102,410-triangle mesh of BASELINE config 3 (mesh_scene(subdiv=6)) and 2^16
random rays from inside its room (chip_smoke.room_rays), it prints one JSON
line per measurement:

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
traversal wrapper (accel.traverse_cuda.traverse_cuda, with its own
accel.clustered.traverse_args), which builds that checkout's kernel, and
prints an ``ab`` line per ray set (config-3 camera rays, random rays at
2^16 and 2^18, closest hit, and the pair route's fallback input): the two
kernels' outputs must be equal bit for bit, and each is timed in turns
(parent, this, this, parent), per single call (``ms``, cuda_ms) and on
the card over 20 calls back to back (``device_ms``).

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

from chip_smoke import (MESH_CFG, N_CHUNK, card_line, cuda_ms, device_ms,
                        fallback_input, mesh_camera_rays, room_rays)


def busy(prof):
    """(kernels, busy ms, span ms, top kernels by device ms, traversal
    kernel ms) of a trace."""
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
    walk = sum(ms for n, ms in by_name.items() if "traverse_kernel" in n)
    return len(ks), total / 1e3, span, [(n[:60], ms) for n, ms in top], walk


def profiled(fn):
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return busy(prof)


def parent_walk(root):
    """The traversal of the checkout at ``root``: that checkout's
    (accel.clustered.traverse_args, accel.traverse_cuda module).  Its
    package is imported under its own name while this one's modules are
    set aside, and its kernel is built (into its own csrc/build) before
    they are put back."""
    name = "tputracer_torch"
    ours = {k: sys.modules.pop(k) for k in list(sys.modules)
            if k == name or k.startswith(name + ".")}
    sys.path.insert(0, str(Path(root).resolve()))
    try:
        from tputracer_torch.accel import clustered, traverse_cuda
        traverse_cuda.load_kernel()
    finally:
        sys.path.pop(0)
        for k in [k for k in sys.modules
                  if k == name or k.startswith(name + ".")]:
            del sys.modules[k]
        sys.modules.update(ours)
    return clustered.traverse_args, traverse_cuda


def ab(root, sc, fallback_in):
    """The parent checkout's traversal kernel against this one, in turns."""
    from tputracer_torch.accel import clustered as cl
    from tputracer_torch.accel import traverse_cuda as tc

    old_args, old_tc = parent_walk(root)
    if old_tc is tc:
        raise SystemExit(f"{root}: imported this checkout, not the parent")
    targs, old_targs = cl.traverse_args(sc), old_args(sc)   # once each
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

        (t_n, p_n), (t_o, p_o) = new(), old()
        torch.cuda.synchronize()
        if not (torch.equal(t_n, t_o) and torch.equal(p_n, p_o)):
            raise SystemExit(f"{name}: the parent kernel's output differs")
        res = {"parent_ms": [], "ms": [], "parent_device_ms": [],
               "device_ms": []}
        for pre, fn in (("parent_", old), ("", new), ("", new),
                        ("parent_", old)):
            res[f"{pre}ms"].append(cuda_ms(fn, 2, 5))
            res[f"{pre}device_ms"].append(device_ms(fn))
        print(json.dumps({"phase": "ab", "rays": name,
                          "n_rays": walk_in[0].shape[0], **res}), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", metavar="DIR",
                        help="an earlier checkout whose traversal kernel "
                             "to time beside this one")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script profiles the card")
    from tputracer_torch.accel import clustered as cl
    from tputracer_torch.accel import pairs
    from tputracer_torch.accel import traverse_cuda as tc
    from tputracer_torch.config import RenderConfig
    from tputracer_torch.integrators.pt import render_pt
    from tputracer_torch.scene import mesh_scene

    card = card_line()
    print(card, flush=True)
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
    if opts.parent:
        ab(opts.parent, sc, f_in)

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
