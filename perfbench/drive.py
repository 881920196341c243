"""One run of one cell: set-up, warm-up, the measured window, the memory
peak, then with ``--trace 1`` the traced stretch and the per-layer
readers, then the program's state freed and the comparison with the
reference.  The stretch comes after the window: once the profiler has
attached CUPTI, every launch stays slower on the host.

The traffic file's ``kind`` names the run's class, ``Kind`` of
``perfbench/kinds/<kind>.py`` (a :class:`Run`): ``turntable`` (frames of
``api.render``) or ``fit`` (chains of ``fit._fit_chain_single``).  This
module names no kind.
"""

from __future__ import annotations

import gc
import statistics
import time

import numpy as np
import torch

from perfbench import check, program, scenes, trace


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def p95_ms(times):
    """The 95th percentile of all the frames' seconds, in ms (numpy's
    linear interpolation between order statistics)."""
    return 1e3 * float(np.percentile(np.asarray(times, np.float64), 95))


def by_stretch(unit_s, values, step=4.0):
    """The mean of ``values`` (one a unit, seconds) in ms over each
    ``step`` seconds of the window, by the units' own times: a warm-up
    left inside the window shows as its first stretches."""
    sums, counts, t = {}, {}, 0.0
    for dt, v in zip(unit_s, values):
        b = int(t // step)
        sums[b] = sums.get(b, 0.0) + v
        counts[b] = counts.get(b, 0) + 1
        t += dt
    return [round(1e3 * sums[b] / counts[b], 3) for b in sorted(sums)]


class Reservoir:
    """A uniform sample of ``size`` items of a stream of unknown length,
    drawn from the seed (Vitter's algorithm R)."""

    def __init__(self, size, seed):
        self.size = size
        self.rng = np.random.default_rng([seed, 2])
        self.items = []
        self.seen = 0

    def offer(self, item):
        if self.seen < self.size:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.items[j] = item
        self.seen += 1


class Run:
    """What every kind shares: the spec, the seed, the device, the
    benchmark's host spans and the process's start.

    A kind defines ``setup()``; ``unit(u)``, one traced unit;
    ``window(seconds) -> (attempted, failed, end-to-end metrics)``, which
    sets ``self.t_window``, its start, and keeps each unit's seconds in
    ``self.host["unit_s"]``; ``free()``;
    ``numbers()``, the compared numbers, once the state is freed; and for
    ``calibrate.py`` ``faults()``, the control's and the planted faults'
    numbers."""

    kind = ""              # what the readers see: "render" or "fit"
    units = 0              # traced frames or chains
    steps_per_unit = 1
    replay = None          # replay(unit, on_closest, on_shadow), renders

    def __init__(self, spec, seed, device):
        self.spec, self.seed, self.device = spec, seed, device
        self.config, self.traffic = spec.config, spec.traffic
        self.host = {}
        self.arrays = scenes.build(self.config)

    def build_scene(self):
        t = time.perf_counter()
        scene = program.build_scene(self.arrays, self.config, self.device)
        sync(self.device)
        self.host["scene_build"] = [time.perf_counter() - t]
        return scene

    def traced(self):
        """The Stretch of ``self.units`` traced units."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        counters = []
        with torch.profiler.profile(activities=acts) as prof:
            for u in range(self.units):
                c0 = program.launch_counts()
                with torch.profiler.record_function(trace.UNIT):
                    self.unit(u)
                c1 = program.launch_counts()
                counters.append({r: c1[r] - c0[r] for r in c1})
        return trace.from_profiler(prof, self.kind, self.steps_per_unit,
                                   counters, self.host, self.replay)

    def calibration_window(self, seconds):
        """The window of a calibration run; a kind may keep more of it."""
        return self.window(seconds)

    def faults(self):
        """{name: numbers} of the control and the planted faults."""
        return {}

    def peak(self):
        """The memory peak of the run's card so far."""
        return (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else 0)

    def release(self):
        """Free the program's state before the reference runs."""
        self.free()
        program.release()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def run(spec, seed, seconds, traced, device, t_start):
    """One run of the cell; the result's fields (without ``device``'s
    name and count)."""
    r = spec.kind(spec, seed, device)
    r.host["setup_entered"] = [time.perf_counter() - t_start]
    r.setup()
    sync(device)
    r.host["setup_left"] = [time.perf_counter() - t_start]
    attempted, failed, e2e = r.window(seconds)
    e2e["setup_s"] = r.t_window - t_start
    peak = r.peak()
    stretch = r.traced() if traced else None
    out = {"attempted": attempted, "failed": failed, "peak": peak}
    if stretch is not None:
        out["per_layer"] = {m["name"]: spec.readers[m["name"]](stretch)
                            for m in spec.per_layer}
        out["busy_s"] = stretch.busy_us() * 1e-6
        out["window_s"] = stretch.span_us() * 1e-6
        out["breakdown"] = trace.breakdown(stretch)
    out["e2e"] = e2e
    unit_s = r.host["unit_s"]
    out["host"] = {k: v for k, v in r.host.items()
                   if k not in ("dispatch", "unit_s")}
    out["host"]["window_unit_mean"] = [statistics.fmean(unit_s)]
    out["by_4s"] = {"unit_ms": by_stretch(unit_s, unit_s)}
    if "dispatch" in r.host:
        out["by_4s"]["dispatch_ms"] = by_stretch(unit_s, r.host["dispatch"])
    if stretch is not None:
        out["host"]["traced_unit_mean"] = [
            stretch.span_us() * 1e-6 / len(stretch.units)]
    r.release()
    out["correct"], out["checks"] = check.judge(r.numbers(),
                                                spec.cell["limits"])
    return out
