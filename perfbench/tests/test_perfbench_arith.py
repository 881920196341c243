"""The harness's own arithmetic on synthetic data: the 95th percentile
over all frames, the union and idle share of device intervals, the most
common count, the breakdown, the reservoir of checked frames and the
turntable's schedule."""

import math

import numpy as np
import pytest

from perfbench import drive, generator, trace


def test_p95_over_all_frames():
    times = [0.040] * 190 + [0.050] * 9 + [0.200]
    assert drive.p95_ms(times) == pytest.approx(
        1e3 * float(np.percentile(times, 95)))
    ramp = [i / 1000 for i in range(1, 201)]       # 1..200 ms
    assert drive.p95_ms(ramp) == pytest.approx(190.05)
    # one slow frame among 200 does not move it; 11 do
    assert drive.p95_ms([0.01] * 199 + [1.0]) == pytest.approx(10.0)
    assert drive.p95_ms([0.01] * 189 + [1.0] * 11) > 500


def _stretch(ops, units, host_ops=()):
    return trace.Stretch("render", 1, sorted(ops), sorted(host_ops),
                         units, [{} for _ in units], {})


def test_union_and_idle():
    ops = [(0, 10, "a"), (5, 15, "b"), (20, 30, "a"), (22, 25, "c"),
           (40, 41, "Memcpy DtoH")]
    assert trace.union_us(ops) == 26
    assert trace.union_us(ops, 8, 21) == 8
    st = _stretch(ops, [(0, 30), (30, 50)])
    assert st.span_us() == 50
    assert st.busy_us() == 26
    assert 100 * (1 - st.busy_us() / st.span_us()) == pytest.approx(48.0)
    assert trace.gaps(ops, 0, 50) == [(15, 20), (30, 40), (41, 50)]
    assert [op[2] for op in st.unit_ops(1)] == ["Memcpy DtoH"]
    assert not trace.is_kernel("Memcpy DtoH") and trace.is_kernel("a")


def test_idle_share_of_the_metric_readers():
    from perfbench import bench

    read = bench.reader("idle_pct.render")
    st = _stretch([(0, 10, "k"), (20, 30, "k")], [(0, 20), (20, 40)])
    assert read(st) is None           # no untraced window yet
    # 10 us busy a traced frame; the window's frames 16, 24, 20 us: the
    # idle share is over the window's mean frame, not the traced span
    st.host["unit_s"] = [16e-6, 24e-6, 20e-6]
    assert read(st) == pytest.approx(50.0)
    st.host["unit_s"] = [12.5e-6]
    assert read(st) == pytest.approx(20.0)
    kernels = bench.reader("kernels_per_frame")
    st = _stretch([(1, 2, "k"), (3, 4, "k"), (21, 22, "k"),
                   (23, 24, "Memset")], [(0, 20), (20, 40)])
    assert kernels(st) == 2.0
    assert bench.reader("idle_pct.fit")(st) is None


def test_mode_prefers_the_most_common_then_the_largest():
    assert trace.mode([7645, 7645, 7644]) == 7645
    assert trace.mode([3, 4]) == 4


def test_breakdown_names_ops_and_host_gaps():
    ops = [(0, 10, "k1"), (12, 30, "k2"), (40, 45, "k1")]
    host = [(0, 50, "perfbench.outer"), (10, 13, "aten::copy_"),
            (30, 41, "cudaGraphLaunch")]
    st = _stretch(ops, [(0, 50)], host)
    b = trace.breakdown(st)
    assert b["device_ops"][0] == ["k2", pytest.approx(18e-6)]
    assert dict(b["idle_gaps"]) == {"cudaGraphLaunch": pytest.approx(10e-6),
                                    "aten::copy_": pytest.approx(2e-6),
                                    "perfbench.outer": pytest.approx(5e-6)}


def test_reservoir_is_seeded_and_uniform():
    def sample(seed, n=50):
        r = drive.Reservoir(2, seed)
        for i in range(n):
            r.offer(i)
        return sorted(r.items)

    assert sample(5) == sample(5)
    counts = np.zeros(50)
    for s in range(2000):
        for i in sample(s):
            counts[i] += 1
    assert counts.sum() == 4000
    assert counts.min() > 40 and counts.max() < 125     # mean 80


@pytest.mark.parametrize("seed", [0, 2**31 + 7, 2**33 + 1])
def test_turntable_schedule(seed):
    cam = {"o": [0.5, 0.5, -1.44], "look_at": [0.5, 0.5, 0.0]}
    tt = generator.Turntable({"yaw_deg": 15, "step_deg": 1,
                              "light_scale": [0.5, 2.0]}, cam, seed)
    idx = [tt.yaw_index(k) for k in range(600)]
    assert sorted(set(idx)) == list(range(31))
    assert all(abs(a - b) == 1 for a, b in zip(idx, idx[1:]))
    # every inner angle is visited equally often over whole sweeps
    assert np.ptp(np.bincount(idx, minlength=31)[1:30]) <= 1
    f = [tt.factor(k) for k in range(1000)]
    assert 0.5 <= min(f) and max(f) <= 2.0
    assert min(f) < 0.55 and max(f) > 1.8
    again = generator.Turntable({"yaw_deg": 15, "step_deg": 1,
                                 "light_scale": [0.5, 2.0]}, cam, seed)
    assert again.start == tt.start and np.array_equal(again.factors,
                                                      tt.factors)
    for o, yaw in zip(tt.origins, tt.yaws):
        off = np.asarray(o, np.float64) - np.asarray(cam["look_at"])
        assert math.hypot(off[0], off[2]) == pytest.approx(1.44, rel=1e-6)
        assert off[1] == pytest.approx(0.0, abs=1e-7)
        assert math.degrees(math.atan2(-off[0], -off[2])) == \
            pytest.approx(yaw, abs=1e-4)
    assert np.allclose(tt.origins[15], cam["o"])


def test_host_ranges_drawn_on_the_device_are_no_device_ops():
    import torch

    class Ev:
        def __init__(self, name, s, e, cuda):
            self.name = name
            self.time_range = type("R", (), {"start": s, "end": e})
            self.device_type = (torch.autograd.DeviceType.CUDA if cuda
                                else torch.autograd.DeviceType.CPU)

    evs = [Ev(trace.UNIT, 0, 100, False), Ev(trace.UNIT, 0, 100, True),
           Ev("Optimizer.step#Adam.step", 10, 20, False),
           Ev("Optimizer.step#Adam.step", 12, 40, True),
           Ev("void kernel<1>(float*)", 30, 35, True),
           Ev("Memcpy DtoH (Device -> Pageable)", 50, 52, True)]
    prof = type("P", (), {"events": lambda self: evs})()
    st = trace.from_profiler(prof, "fit", 8, [{}], {})
    assert st.units == [(0, 100)]
    assert [op[2] for op in st.ops] == ["void kernel<1>(float*)",
                                        "Memcpy DtoH (Device -> Pageable)"]
    assert st.busy_us() == 7
