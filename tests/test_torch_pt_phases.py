"""PT's bounces as phases (``tputracer_torch.trace.phase``) and its live
lanes as counts a graph's replay reads (``trace.device_count``), on the
CPU.

An eager render records ``pt.bounce.0`` to ``pt.bounce.<max_bounces>``
once a chunk, in order, under the render call's root, each with its
``lanes`` and ``kernel`` 0 (the torch route); the phases change no bit; inside a capture (with stand-in
events) a bounce opens on the event that closed the one before.
``device_count`` outside :func:`trace.counting` records nothing and
reads no value; inside it a chunked call hands over its closest-hit rays
per bounce, summed over the chunks, and its path count, which a replay's
record reads summed by name.  The card's graphs are in
test_torch_cuda.py.
"""

import types

import pytest
import torch

from tputracer_torch import api, graphs, trace
from tputracer_torch.config import RenderConfig
from tputracer_torch.integrators import pt
from tputracer_torch.scene import cornell_box

CASES = {
    "spheres": ("spheres", RenderConfig(width=24, height=24, spp=4,
                                        max_bounces=6, rr_start=3,
                                        chunk_size=768)),
    "boxes": ("boxes", RenderConfig(width=16, height=16, spp=2,
                                    max_bounces=4, rr_start=3)),
    "spheres_rr1": ("spheres", RenderConfig(width=16, height=16, spp=4,
                                            max_bounces=3, rr_start=1,
                                            chunk_size=512)),
}


@pytest.fixture(autouse=True)
def _fresh():
    torch.set_num_threads(2)
    trace.reset()
    yield
    trace.reset()


@pytest.mark.parametrize("case", list(CASES))
def test_an_eager_render_records_each_bounce_as_a_phase(case):
    variant, cfg = CASES[case]
    api.render(cornell_box(variant, device="cpu"), cfg)
    (call,) = trace.records("graphs.call")
    n = cfg.width * cfg.height * cfg.spp
    chunk = min(cfg.chunk_size, n)
    chunks = n // chunk
    names = [f"pt.bounce.{b}" for b in range(cfg.max_bounces + 1)]
    recs = {name: trace.records(name) for name in names}
    for name in names:
        assert len(recs[name]) == chunks, name
        for rec in recs[name]:
            assert rec.root == call.id and rec.device is None, name
            assert rec.counts == {"lanes": chunk, "kernel": 0}, name
    for c in range(chunks):
        ends = [(recs[n][c].start_ns, recs[n][c].end_ns) for n in names]
        assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:])), c
    assert not trace.records(f"pt.bounce.{cfg.max_bounces + 1}")
    assert not trace.records("pt.bounce")


class _Null:
    """A phase that records nothing."""

    def __init__(self, name, **counts):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_the_phases_change_no_bit(monkeypatch):
    variant, cfg = CASES["spheres"]
    scene = cornell_box(variant, device="cpu")
    img, st = pt.render_pt(scene, cfg)
    monkeypatch.setattr(pt, "phase", _Null)
    trace.reset()
    img_off, st_off = pt.render_pt(scene, cfg)
    assert not trace.records("pt.bounce.0")
    assert torch.equal(img, img_off)
    assert all(torch.equal(st[k], st_off[k]) for k in st)


class _Event:
    """A stand-in CUDA event that counts its records."""

    def __init__(self, enable_timing=False, external=False):
        self.recorded = 0

    def record(self):
        self.recorded += 1


def test_a_phase_after_another_opens_on_its_closing_event(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    with trace.phase("t.outside") as outside:
        pass
    with trace.capturing() as phases:
        with trace.phase("t.a") as a:
            pass
        with trace.phase("t.b", after=a, lanes=3) as b:
            pass
        with trace.phase("t.c", after=outside):
            pass
    (_, a0, a1), (_, b0, b1), (_, c0, c1) = phases
    assert b0 is a1 and c0 is not b1
    assert all(e.recorded == 1 for e in (a0, a1, b1, c0, c1))
    assert b.counts == {"lanes": 3}


def test_a_captured_chunk_chains_its_bounces(monkeypatch):
    """Inside a capture each chunk's bounces open on the event that closed
    the bounce before: B + 2 events a chunk, each recorded once."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    variant, cfg = CASES["spheres"]
    scene = cornell_box(variant, device="cpu")
    img, _ = pt.render_pt(scene, cfg)
    with trace.capturing() as phases:
        img_c, _ = pt.render_pt(scene, cfg)
    assert torch.equal(img, img_c)
    B, chunks = cfg.max_bounces + 1, 3
    assert [name for name, _, _ in phases] == [
        f"pt.bounce.{b}" for b in range(B)] * chunks
    for c in range(chunks):
        chunk = phases[c * B:(c + 1) * B]
        assert all(chunk[b][1] is chunk[b - 1][2] for b in range(1, B))
    events = {id(e): e for _, b0, b1 in phases for e in (b0, b1)}
    assert len(events) == (B + 1) * chunks
    assert all(e.recorded == 1 for e in events.values())


def test_device_count_outside_a_capture_records_nothing_and_reads_nothing(
        monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a value was read")

    live = torch.tensor([4.0, 3.0, 1.0])
    for name in ("tolist", "item", "cpu", "to", "copy_", "reshape"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    assert trace.device_count("pt.live", live) is None
    assert trace.device_count("pt.lanes", 3) is None
    monkeypatch.undo()
    assert not trace.records("pt.live") and not trace.records("pt.lanes")
    # an eager render outside a capture leaves nothing to read either
    with trace.counting(torch.zeros(8)) as counts:
        pass
    api.render(cornell_box("boxes", device="cpu"), CASES["boxes"][1])
    assert counts == []


def test_a_capture_gets_each_chunked_calls_live_lanes():
    variant, cfg = CASES["spheres"]
    scene = cornell_box(variant, device="cpu")
    host = torch.full((64,), -1.0)
    with trace.counting(host) as counts:
        _, st = pt.render_pt(scene, cfg)
        _, st2 = pt.render_pt(scene, cfg)
    n = cfg.width * cfg.height * cfg.spp
    B = cfg.max_bounces + 1
    assert [name for name, _ in counts] == ["pt.live", "pt.lanes"] * 2
    assert [v for _, v in counts] == [slice(0, B), n, slice(B, 2 * B), n]
    live = st["rays_closest"].tolist()
    assert live[0] == n and live == sorted(live, reverse=True)
    assert live[-1] < live[cfg.rr_start]
    assert torch.equal(host[B:2 * B], st2["rays_closest"])
    assert torch.all(host[2 * B:] == -1.0)
    assert trace.count_values(host, counts[:2]) == {"pt.live": live,
                                                    "pt.lanes": n}
    assert trace.count_values(host, counts) == {
        "pt.live": [2 * x for x in live], "pt.lanes": 2 * n}


def test_device_count_refuses_more_values_than_the_buffer_holds():
    with trace.counting(torch.zeros(4)) as counts:
        trace.device_count("a", torch.ones(3))
        with pytest.raises(RuntimeError, match="4 counted values"):
            trace.device_count("b", torch.ones(2))
    assert [name for name, _ in counts] == ["a"]


def test_a_replay_record_gets_its_counts_once_its_events_are_done():
    class _Timed:
        def __init__(self, t_ms):
            self.t_ms = t_ms

        def query(self):
            return True

        def elapsed_time(self, other):
            return other.t_ms - self.t_ms

    host = torch.tensor([8.0, 5.0, 2.0, 0.0])
    counts = [("pt.live", slice(0, 3)), ("pt.lanes", 8)]
    with trace.span("graphs.launch") as rec:
        pass
    g = types.SimpleNamespace(timing=rec, phases=[], host=host,
                              counts=counts, ready=_Timed(0.0),
                              begin=_Timed(0.5), end=_Timed(2.0))
    graphs.Graph.settle(g)
    assert rec.device == {"wait_ms": 0.5, "replay_ms": 1.5,
                          "pt.live": [8.0, 5.0, 2.0], "pt.lanes": 8}
