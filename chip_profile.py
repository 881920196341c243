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
    kernels per render, busy time, the traced span and the top kernels.

Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import json
import os
import statistics

import torch

from chip_smoke import MESH_CFG, N_CHUNK, card_line, cuda_ms, room_rays


def busy(prof):
    """(kernels, busy ms, span ms, top kernels by device ms) of a trace."""
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
    return len(ks), total / 1e3, span, [(n[:60], ms) for n, ms in top]


def profiled(fn):
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return busy(prof)


def main():
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

    best_t, best_p, resolved = pairs._slot_best(sc, o, d, tmin, tmax, bt0,
                                                bp0, False)
    _, fidx = torch.sort(resolved.to(torch.int32), stable=True)
    f_in = (o[fidx], d[fidx], tmin[fidx],
            torch.where(resolved, 0.0, tmax)[fidx], best_t[fidx],
            best_p[fidx])

    def fallback():
        return tc.traverse_cuda(*f_in, *targs, leaf=sc.leaf_size)

    live = tmax > tmin
    print(json.dumps({
        "phase": "call", "n_rays": N_CHUNK, "card": card,
        "unresolved_rays": int((~resolved & live).sum()),
        "route_ms": cuda_ms(route, 2, 5), "traverse_ms": cuda_ms(walk, 2, 5),
        "fallback_traverse_ms": cuda_ms(fallback, 2, 5),
        "slots_ms": cuda_ms(lambda: pairs._slot_best(
            sc, o, d, tmin, tmax, bt0, bp0, False), 2, 5)}), flush=True)
    n, busy_ms, span_ms, top = profiled(route)
    print(json.dumps({"phase": "call_profile", "what": "pair route, 2^16",
                      "kernels": n, "busy_ms": busy_ms, "span_ms": span_ms,
                      "top": top}), flush=True)

    cfg = RenderConfig(**MESH_CFG)
    before = os.environ.pop("TPUTRACER_PAIRS", None)
    try:
        for route_name in ("default", "pairs"):
            if route_name == "pairs":
                os.environ["TPUTRACER_PAIRS"] = "1"
            wall = [cuda_ms(lambda: render_pt(sc, cfg), 1, 1)
                    for _ in range(3)]
            n, busy_ms, span_ms, top = profiled(lambda: render_pt(sc, cfg))
            print(json.dumps({
                "phase": "render_profile", "route": route_name,
                "untraced_render_ms": statistics.median(wall),
                "kernels": n, "busy_ms": busy_ms, "traced_span_ms": span_ms,
                "top": top}), flush=True)
    finally:
        os.environ.pop("TPUTRACER_PAIRS", None)
        if before is not None:
            os.environ["TPUTRACER_PAIRS"] = before


if __name__ == "__main__":
    main()
