"""The readers of the program's spans (``perfbench/spans.py`` and the
metrics that read it) on a synthetic stretch and synthetic records: the
window is the last record of each of its frames or steps, traced records
are left out, and a reader returns None where records are missing or the
program keeps none."""

import sys
import types

import pytest
import torch

from perfbench import bench, spans, trace

RENDER = ("graph_call_host_ms", "copy_in_host_ms", "graph_launch_host_ms",
          "copy_in_mb_per_frame", "launch_wait_ms", "replay_device_ms")
FIT = ("fit_forward_host_ms", "fit_backward_host_ms",
       "fit_optimizer_host_ms")
SETUP = {"graph_warmup_s": "render", "scene_bvh_s": "render",
         "optimizer_init_s": "fit"}


def stretch(kind, frames, steps_per_unit=1):
    return trace.Stretch(kind, steps_per_unit, [], [], [(0, 1)], [{}],
                         {"unit_s": [0.04] * frames})


def rec(ms, counts=None, device=None):
    return types.SimpleNamespace(ms=ms, counts=counts or {}, device=device)


@pytest.fixture
def kept(monkeypatch):
    """The program's untraced records, by span name, as a dict to fill."""
    store = {}
    monkeypatch.setattr(spans, "records", lambda name: store.get(name))
    return store


def test_the_window_is_the_last_record_of_each_frame(kept):
    # three warm-up calls, then a window of 3 frames
    kept["graphs.call"] = [rec(50.0), rec(80.0), rec(9.0)] + [
        rec(1.0), rec(2.0), rec(3.0)]
    kept["graphs.copy_in"] = [rec(0.5, {"bytes": 2e6})] * 2 + [
        rec(0.25, {"bytes": 19e6})] * 3
    kept["graphs.launch"] = [
        rec(0.1, device={"wait_ms": 9.0, "replay_ms": 90.0}),
        rec(0.2, device={"wait_ms": 0.5, "replay_ms": 40.0}),
        rec(0.4, {"untimed": 1}),
        rec(0.6, device={"wait_ms": 0.25, "replay_ms": 42.0})]
    st = stretch("render", 3)
    read = {m: bench.reader(m)(st) for m in RENDER}
    assert read["graph_call_host_ms"] == pytest.approx(2.0)
    assert read["copy_in_host_ms"] == pytest.approx(0.25)
    assert read["copy_in_mb_per_frame"] == pytest.approx(19.0)
    assert read["graph_launch_host_ms"] == pytest.approx(0.4)
    # the untimed replay is left out of the device means
    assert read["launch_wait_ms"] == pytest.approx(0.375)
    assert read["replay_device_ms"] == pytest.approx(41.0)
    # a fit's reader finds nothing in a render's run
    assert bench.reader("fit_forward_host_ms")(st) is None


def test_a_fit_window_counts_its_steps(kept):
    kept["grad.forward"] = [rec(99.0)] * 16 + [rec(12.0)] * 15 + [
        rec(15.0)]
    kept["grad.backward"] = [rec(10.0)] * 32
    kept["fit.optimizer"] = [rec(1.0)] * 8 + [rec(0.5)] * 16
    st = stretch("fit", 2, steps_per_unit=8)
    read = {m: bench.reader(m)(st) for m in FIT}
    assert read["fit_forward_host_ms"] == pytest.approx(12.1875)
    assert read["fit_backward_host_ms"] == pytest.approx(10.0)
    assert read["fit_optimizer_host_ms"] == pytest.approx(0.5)
    assert bench.reader("graph_call_host_ms")(st) is None


def test_too_few_records_or_none_read_none(kept):
    st = stretch("render", 4)
    kept["graphs.call"] = [rec(1.0)] * 3
    assert bench.reader("graph_call_host_ms")(st) is None
    assert bench.reader("copy_in_host_ms")(st) is None
    kept["graphs.launch"] = [rec(0.1, {"untimed": 1})] * 4
    assert bench.reader("replay_device_ms")(st) is None
    st.host["unit_s"] = []
    kept["graphs.call"] = [rec(1.0)] * 5
    assert bench.reader("graph_call_host_ms")(st) is None
    for name, kind in SETUP.items():
        assert bench.reader(name)(stretch(kind, 3)) is None, name


def test_set_up_sums_every_untraced_record(kept):
    kept["graphs.eager"] = [rec(1200.0), rec(3.0, {"ungraphed": 1})]
    kept["graphs.capture"] = [rec(800.0)]
    kept["scene.bvh"] = [rec(400.0)]
    kept["fit.make_optimizer"] = [rec(7000.0), rec(1.0)]
    render, fit = stretch("render", 3), stretch("fit", 3, 8)
    # a call that is never graphed is no warm-up of a graph
    assert bench.reader("graph_warmup_s")(render) == pytest.approx(2.0)
    assert bench.reader("scene_bvh_s")(render) == pytest.approx(0.4)
    assert bench.reader("optimizer_init_s")(fit) == pytest.approx(7.001)
    assert bench.reader("optimizer_init_s")(render) is None


def test_traced_records_are_not_the_window():
    """Real records of the program: those made while the profiler ran
    (the traced stretch) stay out of the window's."""
    from tputracer_torch import trace as program_trace

    program_trace.reset()
    try:
        for _ in range(2):
            with program_trace.span("graphs.call"):
                pass
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            for _ in range(3):
                with program_trace.span("graphs.call"):
                    pass
        st = stretch("render", 2)
        window = spans.window(st, "graphs.call")
        assert [r.id for r in window] == [
            r.id for r in program_trace.records("graphs.call")]
        assert all(not r.traced for r in window)
        assert bench.reader("graph_call_host_ms")(st) is not None
        st.host["unit_s"] = [0.04] * 3
        assert bench.reader("graph_call_host_ms")(st) is None
    finally:
        program_trace.reset()


def test_a_program_without_spans_reads_none(monkeypatch):
    """An older program has no ``tputracer_torch.trace``: no reader
    raises, each returns None."""
    import tputracer_torch

    monkeypatch.setitem(sys.modules, "tputracer_torch.trace", None)
    monkeypatch.delattr(tputracer_torch, "trace", raising=False)
    assert spans.records("graphs.call") is None
    for name in RENDER + tuple(SETUP):
        assert bench.reader(name)(stretch("render", 3)) is None, name
    for name in FIT:
        assert bench.reader(name)(stretch("fit", 3, 8)) is None, name
