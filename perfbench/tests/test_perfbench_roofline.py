"""``perfbench/roofline.py`` counts the work ``chip_smoke.py``'s bound
functions count, on the same CPU rays; its bound is theirs with the peak
rescaled from 33.5 T ops/s (an FMA as two) to 67 TFLOP/s, each multiply
and add one operation."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import program, roofline

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    return chip_smoke


def box_rays(n, seed):
    """chip_smoke.random_rays on the CPU: from inside the box, a quarter
    dead."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(0.02, 0.98, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.full(n, 3.0e38, np.float32)
    tmax[::4] = 0.0
    return tuple(torch.from_numpy(x) for x in
                 (o, d, np.zeros(n, np.float32), tmax))


def test_b1_work_and_bound_match_chip_smoke(smoke):
    from tputracer_torch.scene.cornell import cornell_box

    scene = cornell_box("boxes", device="cpu")
    o, d, tmin, tmax = box_rays(4096, 3)
    live = tmax > tmin
    args = program.b1_tables(scene)
    ops, nbytes = roofline.intersect_work(o, d, live, args)
    s_ops, s_bytes, _ = smoke.intersect_work(o, d, live, args)
    assert (ops, nbytes) == (s_ops, s_bytes)
    ms, by, _ = smoke.intersect_bound(o, d, live, args)
    assert by == "operations"
    assert roofline.bound_s(ops, nbytes) * 1e3 == pytest.approx(
        ms * smoke.PEAK_OPS / roofline.PEAK_FLOPS, rel=1e-12)


def test_b2_work_and_bound_match_chip_smoke(smoke):
    from tputracer_torch.accel import clustered

    scene = smoke.soup_scene(2048, 5, device="cpu")
    o, d, tmin, tmax, _ = smoke.soup_rays(512, 6, device="cpu")
    args = program.b2_tables(scene)
    t_final, _ = clustered._traverse(o, d, tmin, tmax,
                                     tmax.clone(), torch.full_like(
                                         tmax, -1, dtype=torch.int32),
                                     *args, leaf=scene.leaf_size,
                                     any_hit=False)
    ops, nbytes = roofline.walk_work(o, d, tmin, tmax, t_final, args,
                                     scene.leaf_size)
    ms, by, _ = smoke.walk_bound(o, d, tmin, tmax, t_final, args,
                                 scene.leaf_size)
    assert by == "operations"
    assert roofline.bound_s(ops, nbytes) * 1e3 == pytest.approx(
        ms * smoke.PEAK_OPS / roofline.PEAK_FLOPS, rel=1e-12)


def test_bound_is_the_larger_of_operations_and_bytes():
    assert roofline.bound_s(67e12, 0) == 1.0
    assert roofline.bound_s(0, 3.35e12) == 1.0
    assert roofline.bound_s(67e9, 3.35e12) == 1.0
