"""The one traffic generator: what each unit of a cell's traffic asks of
the program, made from ``--seed`` and the traffic file's parameters.

A traffic file (``perfbench/traffic/<name>.json``) names its ``kind``,
whose run (``perfbench/kinds/<kind>.py``) draws on what is here:

  * ``turntable``: a look-dev viewer renders frame after frame while the
    camera yaws about the configuration's ``look_at``, at its published
    distance and height, back and forth over ``yaw_deg`` in steps of
    ``step_deg``; the starting angle and direction come from the seed, and
    so does each frame's light scale, ``2 ** U(log2 range)``;
  * ``fit``: inverse rendering from the configuration's true materials,
    the differentiable tables scaled by ``start_scale`` at the start, in
    chains of ``chain`` optimizer steps.

Every seed gives the same set of angles and the same amount of work, in
another order.
"""

from __future__ import annotations

import math

import numpy as np

# frames whose light scale is drawn ahead; the schedule repeats after them
N_FACTORS = 1 << 16


class Turntable:
    """Frame k of a turntable: its camera's yaw index and light scale."""

    def __init__(self, traffic, camera, seed):
        rng = np.random.default_rng(seed)
        half, step = traffic["yaw_deg"], traffic["step_deg"]
        n = int(round(2 * half / step)) + 1
        self.yaws = [-half + i * step for i in range(n)]
        self.period = 2 * (n - 1)
        self.start = int(rng.integers(0, self.period))
        lo, hi = (math.log2(x) for x in traffic["light_scale"])
        self.factors = np.exp2(rng.uniform(lo, hi, N_FACTORS)).astype(
            np.float32)
        self.origins = [yawed_origin(camera, y) for y in self.yaws]

    def yaw_index(self, k):
        """The position of frame k on the back-and-forth sweep."""
        i = (self.start + k) % self.period
        return i if i < len(self.yaws) else self.period - i

    def factor(self, k):
        return self.factors[k % N_FACTORS]


def yawed_origin(camera, yaw_deg):
    """The camera's origin turned by yaw_deg about the vertical axis
    through its look_at point: the same distance and height."""
    o = np.asarray(camera["o"], np.float64)
    c = np.asarray(camera["look_at"], np.float64)
    x, y, z = o - c
    a = math.radians(yaw_deg)
    return (c + np.array([x * math.cos(a) + z * math.sin(a), y,
                          -x * math.sin(a) + z * math.cos(a)])).astype(
                              np.float32)


def flat_rays(traffic):
    """Flat rays of one frame, BASELINE's count: paths x (2 bounces + 1)."""
    r = traffic["render"]
    return (r["width"] * r["height"] * r["spp"]
            * (2 * r["max_bounces"] + 1))


def fit_start(materials, traffic):
    """The fit's starting tables: each differentiable table of the true
    materials times its ``start_scale``, as float32 arrays."""
    tables = material_tables(materials)
    return {k: (tables[k] * np.float32(s)).astype(np.float32)
            for k, s in traffic["start_scale"].items()}


def material_tables(materials):
    """The material dicts as the program's (M,) / (M, 3) tables."""
    return {
        "mat_kind": np.array([m["kind"] for m in materials], np.int32),
        "mat_albedo": np.array([m["albedo"] for m in materials], np.float32),
        "mat_emission": np.array([m["emission"] for m in materials],
                                 np.float32),
        "mat_ior": np.array([m["ior"] for m in materials], np.float32),
    }
