"""The spheres cell, ``spheres_turntable`` (BASELINE config 2), on the
CPU: its frozen generator builds ``cornell_box("spheres")`` field for
field; the plain reference against ``api.render`` on the cell's
configuration at 24x24, 4 spp, 6 bounces, ``rr_start`` 3, judged by the
cell's own limits, and the control (the reference in bfloat16) failing
them; the cell found by name with its per-layer metrics; its flat rays;
and the two readers of the bounces after Russian roulette on records of
a program with and without the bounces' phases and counts."""

import types
from pathlib import Path

import pytest
import torch

from perfbench import bench, check, generator, program, scenes
from perfbench.tests.test_perfbench_reference import frame_inputs, \
    program_image

ROOT = Path(__file__).resolve().parents[2]
CELL = "spheres_turntable"
SMALL = dict(width=24, height=24, spp=4, max_bounces=6, rr_start=3,
             chunk_size=1 << 12)


def test_frozen_generator_builds_the_programs_scene():
    from tputracer_torch.scene.cornell import cornell_box
    from tputracer_torch.scene.types import CAMERA_FIELDS, TENSOR_FIELDS

    cfg = bench.load(ROOT, CELL).config
    arrays = scenes.build(cfg)
    assert arrays.tris.shape == (cfg["n_triangles"], 3, 3) == (12, 3, 3)
    assert [(c, r, m) for c, r, m in arrays.spheres] == [
        ((0.30, 0.18, 0.35), 0.18, 5), ((0.70, 0.18, 0.65), 0.18, 4)]
    ours = program.build_scene(arrays, cfg, "cpu")
    theirs = cornell_box("spheres", device="cpu")
    assert ours.n_tris == theirs.n_tris == 12
    assert ours.n_clusters == theirs.n_clusters == 0
    for f in TENSOR_FIELDS:
        assert torch.equal(getattr(ours, f), getattr(theirs, f)), f
    for f in CAMERA_FIELDS:
        assert torch.equal(getattr(ours.camera, f),
                           getattr(theirs.camera, f)), f


@pytest.mark.parametrize("seed", [2**31 + 99, 12345])
def test_reference_matches_api_render_within_the_cells_limits(seed):
    k = 5
    spec, arrays, em, origin = frame_inputs(CELL, seed, k)
    img = program_image(spec, arrays, em, origin, SMALL, seed)
    assert img.mean() > 1e-2
    pixels = check.pixel_sample(SMALL, None, seed)
    readings = check.render_readings(
        arrays, spec.config, SMALL, seed, [(k, img)], pixels,
        torch.device("cpu"), lambda _: em, lambda _: origin)
    limits = spec.cell["limits"]
    assert check.judge(readings[0], limits)[0], readings
    # the control: the reference in bfloat16 in the program's place
    ctl = check.reference_pixels(arrays, spec.config, SMALL, seed, em,
                                 origin, pixels, torch.device("cpu"),
                                 torch.bfloat16)
    got = check.image_numbers(ctl, check.reference_pixels(
        arrays, spec.config, SMALL, seed, em, origin, pixels,
        torch.device("cpu"), torch.float32))
    assert not check.judge(got, limits)[0], got


def test_the_cell_is_found_by_name():
    spec = bench.load(ROOT, CELL)
    assert spec.kind is bench.kind("turntable")
    assert spec.config["name"] == "cornell_spheres"
    assert spec.config["reduced"] == []
    r = spec.traffic["render"]
    assert (r["width"], r["height"], r["spp"], r["max_bounces"],
            r["rr_start"], r["chunk_size"]) == (256, 256, 64, 6, 3, 1 << 20)
    assert generator.flat_rays(spec.traffic) == 4_194_304 * 13 \
        == 54_525_952
    assert {m["name"] for m in spec.end_to_end} == {
        "rays_per_s", "frame_ms_p95", "setup_s"}
    assert {m["name"] for m in spec.per_layer} == {
        "shading_ms_per_frame", "kernels_per_frame", "b1_roofline_pct",
        "idle_pct.render", "replay_device_ms", "pt_rr_bounce_device_ms",
        "pt_rr_live_lane_pct"}


class _Run:
    """A stand-in run: its traffic, and the replay the stretch carries."""

    def __init__(self, render):
        self.traffic = {"render": render}

    def replay(self, unit, on_closest, on_shadow):
        pass


def stretch(frames, render=SMALL, kind="render"):
    return types.SimpleNamespace(kind=kind, steps_per_unit=1,
                                 host={"unit_s": [0.05] * frames},
                                 replay=_Run(render).replay)


def launch_records(monkeypatch, devices):
    """The program's ``graphs.launch`` records, with these device dicts."""
    from tputracer_torch import trace

    trace.reset()
    for dev in devices:
        with trace.span("graphs.launch") as rec:
            pass
        rec.device = dev
    monkeypatch.setattr(trace, "SETTLERS", [])


def test_the_readers_read_the_bounces_after_russian_roulette(monkeypatch):
    rd_ms = bench.reader("pt_rr_bounce_device_ms")
    rd_pct = bench.reader("pt_rr_live_lane_pct")
    lanes = 4096
    dev = {"replay_ms": 9.0, "pt.lanes": lanes,
           **{f"pt.bounce.{b}": 1.0 + b for b in range(7)}}
    live = [4096, 3000, 2000, 1500, 400, 200, 100]
    launch_records(monkeypatch, [dict(dev, **{"pt.live": live}),
                                 dict(dev, **{"pt.live": [x // 2 for x in
                                                          live]}),
                                 None])
    # two timed frames of the window; the last replay is untimed
    st = stretch(3)
    # bounces 4, 5 and 6 (rr_start 3)
    assert rd_ms(st) == pytest.approx(5.0 + 6.0 + 7.0)
    want = 100.0 * (700 / 3 / lanes + 350 / 3 / lanes) / 2
    assert rd_pct(st) == pytest.approx(want)
    assert rd_ms(stretch(3, kind="fit")) is None
    assert rd_pct(stretch(3, dict(SMALL, rr_start=9))) is None
    # a program without the bounces' phases and counts reads None
    launch_records(monkeypatch, [{"replay_ms": 9.0, "wait_ms": 0.1}] * 3)
    assert rd_ms(st) is None and rd_pct(st) is None
