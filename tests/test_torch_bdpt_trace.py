"""BDPT's phases as spans (``tputracer_torch.trace.phase``) and, inside a
CUDA graph, as device-timed stretches of each replay.

On the CPU: an eager ``render_bdpt`` records ``bdpt.eye_walk``,
``bdpt.light_walk``, ``bdpt.s0``, ``bdpt.connect`` and ``bdpt.splat`` once
a chunk, in that order, under the render call's root, with their counts;
the spans change no bit; a phase outside a capture makes no event, and
inside :func:`trace.capturing` (with stand-in events) hands its pair to
the capture; a replay's record sums each phase's pairs.  On the card
(``cuda``): a graphed replay's ``graphs.launch`` record carries the five
phases' device ms, whose sum is at most the replay's and at least 80% of
it; the BDPT graph gains two event nodes a phase and chunk and no kernel;
a PT graph holds no BDPT phase, only its bounces'.
"""

import types

import pytest
import torch

from tputracer_torch import api, graphs, trace
from tputracer_torch.config import BdptConfig, RenderConfig
from tputracer_torch.integrators import bdpt
from tputracer_torch.scene import cornell_box

SMALL = BdptConfig(width=24, height=24, spp=4, max_bounces=4,
                   chunk_size=24 * 4 * 8)
PHASES = ("bdpt.eye_walk", "bdpt.light_walk", "bdpt.s0", "bdpt.connect",
          "bdpt.splat")


@pytest.fixture(autouse=True)
def _fresh():
    torch.set_num_threads(2)
    trace.reset()
    yield
    trace.reset()


def test_an_eager_render_records_each_phase_once_a_chunk():
    scene = cornell_box("caustic", device="cpu")
    api.render_bdpt(scene, SMALL)
    (call,) = trace.records("graphs.call")
    chunks = SMALL.width * SMALL.height * SMALL.spp // SMALL.chunk_size
    assert chunks == 3
    V = SMALL.max_bounces + 2
    # on the CPU the torch routes: kernel 0
    counts = {"bdpt.eye_walk": {"verts": V, "kernel": 0},
              "bdpt.light_walk": {"verts": V, "kernel": 0},
              "bdpt.s0": {},
              # t = 2..V with s = 1..V - t: 4 + 3 + 2 + 1
              "bdpt.connect": {"strategies": 10, "kernel": 0},
              "bdpt.splat": {"strategies": V - 1, "kernel": 0}}
    recs = {name: trace.records(name) for name in PHASES}
    for name in PHASES:
        assert len(recs[name]) == chunks, name
        for rec in recs[name]:
            assert rec.root == call.id and rec.device is None, name
            assert rec.counts == dict(
                lanes=SMALL.chunk_size, **counts[name]), name
    for c in range(chunks):
        ends = [(recs[n][c].start_ns, recs[n][c].end_ns) for n in PHASES]
        assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:])), c


class _Null:
    """A phase that records nothing."""

    def __init__(self, name, **counts):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, **counts):
        pass


def test_the_spans_change_no_bit(monkeypatch):
    scene = cornell_box("caustic", device="cpu")
    img, st = bdpt.render_bdpt(scene, SMALL)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        img_p, _ = bdpt.render_bdpt(scene, SMALL)
    assert len(trace.records("bdpt.splat", traced=True)) == 3
    monkeypatch.setattr(bdpt, "phase", _Null)
    trace.reset()
    img_off, st_off = bdpt.render_bdpt(scene, SMALL)
    assert not trace.records("bdpt.eye_walk")
    assert torch.equal(img, img_p) and torch.equal(img, img_off)
    assert all(torch.equal(st[k], st_off[k]) for k in st)


class _Event:
    def __init__(self, enable_timing=False, external=False):
        self.recorded = 0

    def record(self):
        self.recorded += 1


def test_a_phase_makes_events_only_inside_a_capture(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    with trace.phase("t.phase", lanes=4) as outside:
        pass
    assert outside.counts == {"lanes": 4}
    with trace.capturing() as phases:
        with trace.phase("t.phase"):
            with trace.span("t.plain"):
                pass
        with trace.phase("t.other"):
            pass
        with trace.phase("t.phase"):
            pass
    assert [name for name, _, _ in phases] == ["t.phase", "t.other",
                                               "t.phase"]
    assert all(b.recorded == 1 and e.recorded == 1 for _, b, e in phases)
    with trace.phase("t.phase"):
        pass
    assert len(phases) == 3
    assert len(trace.records("t.phase")) == 4


class _Timed:
    def __init__(self, t_ms):
        self.t_ms = t_ms

    def elapsed_time(self, other):
        return other.t_ms - self.t_ms


def test_a_replay_sums_each_phases_pairs():
    phases = [("a", _Timed(1.0), _Timed(3.5)), ("b", _Timed(3.5),
                                                   _Timed(4.0)),
              ("a", _Timed(4.0), _Timed(5.0))]
    assert trace.phase_ms(phases) == {"a": 3.5, "b": 0.5}
    with trace.span("graphs.launch") as rec:
        pass
    g = types.SimpleNamespace(
        timing=rec, phases=phases, host=torch.zeros(0), counts=[],
        ready=_Timed(0.5), begin=_Timed(1.0),
        end=types.SimpleNamespace(query=lambda: True, t_ms=5.25))
    graphs.Graph.settle(g)
    assert rec.device == {"wait_ms": 0.5, "replay_ms": 4.25, "a": 3.5,
                          "b": 0.5}


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_a_graphed_replay_times_the_phases_on_the_device():
    need_card()
    graphs.clear()
    sc = cornell_box("caustic", device="cuda")
    cfg = BdptConfig(width=128, height=128, spp=8, max_bounces=4,
                     chunk_size=1 << 16)
    eager, _ = bdpt.render_bdpt(sc, cfg)
    for _ in range(5):   # eager, the capture and its replay, replays
        img, _ = api.render_bdpt(sc, cfg)
        # a viewer's wait for the frame: the replay's events are done by
        # the next replay, which would otherwise leave it untimed
        torch.cuda.synchronize()
    torch.testing.assert_close(img, eager, rtol=1e-5, atol=1e-7)
    recs = trace.records("graphs.launch")
    assert len(recs) == 4
    for rec in recs:
        assert rec.device is not None and "untimed" not in rec.counts
        parts = [rec.device[name] for name in PHASES]
        assert all(p > 0 for p in parts), rec.device
        assert 0.8 * rec.device["replay_ms"] <= sum(parts) \
            <= rec.device["replay_ms"], rec.device
    (g,) = graphs.graphs()
    chunks = cfg.width * cfg.height * cfg.spp // cfg.chunk_size
    assert len(g.phases) == len(PHASES) * chunks
    assert g.census["event_nodes"] == 2 + 2 * len(PHASES) * chunks
    assert g.census["fused_intersect_kernel"] == 25 * chunks
    graphs.clear()


@pytest.mark.cuda
def test_a_pt_graph_holds_no_phase_nodes():
    """No BDPT phase node: a PT graph's phases are its bounces, each
    opening on the event node that closed the bounce before (B + 2 event
    nodes a chunk), and its record holds their device ms and its counts
    beside the replay's times."""
    need_card()
    graphs.clear()
    sc = cornell_box("boxes", device="cuda")
    cfg = RenderConfig(width=64, height=64, spp=4, max_bounces=4,
                       chunk_size=1 << 13)
    for _ in range(3):
        api.render(sc, cfg)
    torch.cuda.synchronize()
    (g,) = graphs.graphs()
    bounces = [f"pt.bounce.{b}" for b in range(cfg.max_bounces + 1)]
    chunks = 2
    assert [name for name, _, _ in g.phases] == bounces * chunks
    assert not set(PHASES) & {name for name, _, _ in g.phases}
    assert g.census["event_nodes"] == 2 + (len(bounces) + 1) * chunks
    rec = trace.records("graphs.launch")[-1]
    assert set(rec.device) == {"wait_ms", "replay_ms", "pt.live",
                               "pt.lanes", *bounces}
    graphs.clear()
