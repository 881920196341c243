"""tputracer_torch.trace on the CPU: spans, their records and where the
program opens them.

A span's record holds its name, its id, its parent's and its request
root's ids, its start and end and its counts; records go into a bounded
ring per name, in a traced bin while a torch profiler runs and an
untraced one otherwise; under a profiler each span is a
``record_function`` named ``tputracer.<name>`` on the profiler's own
timeline, and with none running no ``record_function`` is made.  Then
the program's sites: a fit step's phases, the scene build and its BVH,
a CPU ``api.render``, a PT bounce's phases, and the lazy device timing of
a graph's replay (with stand-in events: the card's own are in
test_torch_cuda.py).
"""

import threading
import types

import pytest
import torch

from tputracer_torch import api, fit, graphs, trace
from tputracer_torch.config import RenderConfig
from tputracer_torch.integrators.pt import render_pt
from tputracer_torch.scene import cornell_box, mesh_scene
from tputracer_torch.trace import span

SMALL = RenderConfig(width=16, height=16, spp=2, max_bounces=3, rr_start=2)


@pytest.fixture(autouse=True)
def _fresh():
    torch.set_num_threads(2)
    trace.reset()
    yield
    trace.reset()


def inside(child, parent):
    return (child.parent == parent.id and child.root == parent.root
            and parent.start_ns <= child.start_ns
            and child.end_ns <= parent.end_ns)


def test_nesting_gives_parents_and_request_roots():
    with span("t.request") as req:
        with span("t.a") as a:
            with span("t.b") as b:
                pass
        with span("t.c") as c:
            pass
    with span("t.request") as req2:
        pass
    assert (req.parent, req.root) == (0, req.id)
    assert inside(a, req) and inside(c, req) and inside(b, a)
    assert b.root == req.id and b.parent == a.id
    assert (req2.parent, req2.root) == (0, req2.id) and req2.id > req.id
    assert len({req.id, a.id, b.id, c.id, req2.id}) == 5
    assert [r.id for r in trace.records("t.request")] == [req.id, req2.id]
    assert a.ms >= b.ms >= 0


def test_a_span_that_raises_is_still_recorded_and_closed():
    with pytest.raises(ValueError):
        with span("t.outer"):
            with span("t.fails"):
                raise ValueError("no")
    with span("t.after") as after:
        pass
    (failed,) = trace.records("t.fails")
    assert failed.end_ns >= failed.start_ns
    assert after.parent == 0


def test_counts_are_added():
    with span("t.copy", tensors=2) as rec:
        rec.add(bytes=10)
        rec.add(bytes=5, tensors=1)
    assert trace.records("t.copy")[0].counts == {"tensors": 3, "bytes": 15}


def test_ring_keeps_the_newest(monkeypatch):
    assert trace.RING >= 65_536
    monkeypatch.setattr(trace, "RING", 4)
    ids = []
    for _ in range(10):
        with span("t.ring") as rec:
            pass
        ids.append(rec.id)
    assert [r.id for r in trace.records("t.ring")] == ids[-4:]


def test_threads_keep_their_own_nesting():
    got = {}

    def worker(k):
        with span("t.thread") as outer:
            with span("t.inner") as inner:
                got[k] = (outer, inner)

    with span("t.main") as main:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    for outer, inner in got.values():
        assert outer.parent == 0 and outer.root == outer.id != main.id
        assert inner.parent == outer.id and inner.root == outer.id


def test_traced_and_untraced_bins():
    with span("t.bin"):
        pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with span("t.bin") as traced:
            pass
    with span("t.bin"):
        pass
    assert [r.id for r in trace.records("t.bin", traced=True)] == \
        [traced.id]
    assert len(trace.records("t.bin")) == 2
    assert traced.id not in [r.id for r in trace.records("t.bin")]


def test_spans_lie_on_the_profilers_timeline_around_their_ops():
    x = torch.ones(64)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("t.outer"):
            y = x + 1.0
            with span("t.inner"):
                torch.mul(y, 2.0)
    events = {}
    for ev in prof.events():
        events.setdefault(ev.name, []).append(ev.time_range)
    (outer,) = events["tputracer.t.outer"]
    (inner,) = events["tputracer.t.inner"]
    assert outer.start <= inner.start and inner.end <= outer.end
    (add,) = events["aten::add"]
    assert outer.start <= add.start and add.end <= inner.start
    (mul,) = events["aten::mul"]
    assert inner.start <= mul.start and mul.end <= inner.end


def test_no_record_function_without_a_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function made with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    with span("t.off") as rec:
        torch.ones(4).sum()
    assert trace.records("t.off") == [rec]


def test_spanned_times_each_call():
    @trace.spanned("t.deco")
    def f(a, b=1):
        return a + b

    assert f(1, b=2) == 3 and f(5) == 6
    assert len(trace.records("t.deco")) == 2
    assert f.__name__ == "f"


def test_records_settle_late_device_times_first(monkeypatch):
    rec = span("t.late")
    with rec:
        pass

    def settle():
        rec.device = {"replay_ms": 1.5}

    monkeypatch.setattr(trace, "SETTLERS", [settle])
    assert trace.records("t.late")[0].device == {"replay_ms": 1.5}


def test_fit_chain_leaves_a_step_and_its_phases():
    """A 2-step chain: two records of each phase, each inside its step."""
    scene = cornell_box("boxes", device="cpu")
    with torch.no_grad():
        target = render_pt(scene, SMALL)[0]
    params = {"mat_albedo": (scene.mat_albedo * 0.5).requires_grad_(),
              "mat_emission": (scene.mat_emission * 2.0).requires_grad_()}
    opt = fit._adam(list(params.values()), 1e-2)
    fit._fit_chain_single(scene, params, target, SMALL, opt, 2)
    assert len(trace.records("fit.make_optimizer")) == 1
    steps = trace.records("fit.step")
    assert len(steps) == 2 and all(s.parent == 0 for s in steps)
    for name in ("grad.forward", "grad.backward", "fit.optimizer"):
        recs = trace.records(name)
        assert len(recs) == 2, name
        for rec, step in zip(recs, steps):
            assert inside(rec, step), name
    fwd, bwd, opt_rec = (trace.records(n)[0] for n in
                         ("grad.forward", "grad.backward", "fit.optimizer"))
    assert fwd.end_ns <= bwd.start_ns and bwd.end_ns <= opt_rec.start_ns
    # the bounces' phases lie inside the forward
    shadow = [r for r in trace.records("pt.shadow")
              if r.root == steps[0].id]
    assert len(shadow) == SMALL.max_bounces


def test_make_scene_records_its_bvh_inside_its_build():
    scene = mesh_scene(subdiv=2, leaf_size=32, accel="cluster", device="cpu")
    (build,) = trace.records("scene.build")
    (bvh,) = trace.records("scene.bvh")
    assert inside(bvh, build) and build.parent == 0
    assert bvh.counts["clusters"] == scene.n_clusters > 0
    cornell_box("boxes", device="cpu")
    assert len(trace.records("scene.build")) == 2
    assert len(trace.records("scene.bvh")) == 1


def test_cpu_render_is_an_ungraphed_call_with_its_bounces():
    scene = cornell_box("boxes", device="cpu")
    api.render(scene, SMALL)
    (call,) = trace.records("graphs.call")
    (eager,) = trace.records("graphs.eager")
    assert inside(eager, call) and eager.counts == {"ungraphed": 1}
    assert not trace.records("graphs.key")
    bounces = SMALL.max_bounces + 1
    # a draw for the camera, the light and the BSDF at every bounce but
    # the last, Russian roulette's from rr_start on
    draws = 1 + 2 * (bounces - 1) + (bounces - 1 - SMALL.rr_start)
    for name, n in (("pt.intersect", bounces), ("pt.emission", bounces),
                    ("pt.light", bounces - 1), ("pt.shadow", bounces - 1),
                    ("pt.sample", bounces - 1), ("pt.roulette", bounces - 1),
                    ("pt.film", 1), ("rng.uniform3", draws)):
        recs = trace.records(name)
        assert len(recs) == n, name
        assert all(r.root == call.id for r in recs), name


class _Event:
    def __init__(self, t_ms, done=True):
        self.t_ms, self.done = t_ms, done

    def query(self):
        return self.done

    def elapsed_time(self, other):
        return other.t_ms - self.t_ms


def _replayed(ready, begin, end):
    """A stand-in Graph after one replay, its events at those times."""
    with span("graphs.launch") as rec:
        pass
    return types.SimpleNamespace(timing=rec, phases=[], host=torch.zeros(0),
                                 counts=[], ready=_Event(ready),
                                 begin=_Event(begin),
                                 end=_Event(end, done=end is not None))


def test_a_replay_gets_its_device_times_once_its_events_are_done():
    g = _replayed(10.0, 10.25, 52.0)
    graphs.Graph.settle(g)
    (rec,) = trace.records("graphs.launch")
    assert rec.device == {"wait_ms": 0.25, "replay_ms": 41.75}
    assert g.timing is None and "untimed" not in rec.counts


def test_a_replay_not_done_waits_then_is_untimed():
    g = _replayed(10.0, 10.25, None)
    graphs.Graph.settle(g)              # a read: nothing waits
    assert g.timing is not None and g.timing.device is None
    graphs.Graph.settle(g, final=True)  # the graph's next replay
    (rec,) = trace.records("graphs.launch")
    assert rec.device is None and rec.counts == {"untimed": 1}
    assert g.timing is None
