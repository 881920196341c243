"""The BDPT cell, ``caustic_bdpt_turntable``, on the CPU: its BDPT
reference against ``api.render_bdpt`` at 24x24, 4 spp, 4 bounces on the
caustics box and on the diffuse Cornell box (MIS chains without a delta
vertex), at the golden test's tolerances; its flat rays; the cell found by
name; its set-up free of JAX and the reference free of the program; a
sound run correct and a run with each planted fault not."""

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import bench, check, drive, generator, program, scenes
from perfbench.reference import bdpt as ref_bdpt
from perfbench.reference import pt as ref_pt
from perfbench.tests.test_perfbench_imports import run_blocked

ROOT = Path(__file__).resolve().parents[2]
CELL = "caustic_bdpt_turntable"
KIND = bench.module("kinds", "bdpt_turntable")


def golden(prog, refp):
    """``tests/golden/test_pt_vs_oracle.py``'s tolerances."""
    rel = np.abs(prog - refp) / (1.0 + np.abs(refp))
    return float(rel.mean()) < 5e-4 and float((rel > 5e-3).mean()) < 0.01


@pytest.mark.parametrize("config", ["cornell_caustic", "cornell_boxes"])
@pytest.mark.parametrize("seed", [2**31 + 99, 12345])
def test_reference_matches_api_render_bdpt(config, seed):
    from tputracer_torch import api

    cfg = json.loads((ROOT / "perfbench" / "configs" / f"{config}.json")
                     .read_text())
    arrays = scenes.build(cfg)
    tt = generator.Turntable(bench.load(ROOT, CELL).traffic, cfg["camera"],
                             seed)
    k = 5
    em = generator.material_tables(arrays.materials)["mat_emission"] \
        * tt.factor(k)
    origin = tt.origins[tt.yaw_index(k)]
    r = dict(width=24, height=24, spp=4, max_bounces=4, chunk_size=24 * 4 * 8,
             mis_power=False)
    scene = program.with_tables(
        program.build_scene(arrays, cfg, "cpu"),
        camera=program.camera(cfg["camera"], origin, "cpu"),
        mat_emission=torch.as_tensor(em))
    img = api.render_bdpt(scene, KIND.render_config(r, seed))[0].numpy()
    assert img.mean() > 1e-2
    cam = cfg["camera"]

    def reference(dtype):
        sc = ref_pt.make_ref_scene(arrays, eps=cfg["scene"]["eps"],
                                   device="cpu", dtype=dtype,
                                   emission=torch.as_tensor(em))
        c = ref_pt.camera(origin, cam["look_at"], cam["up"], cam["vfov_deg"],
                          cam["aspect"], "cpu", dtype)
        return ref_bdpt.render_image(sc, c, r, seed, chunk=1000).float() \
            .numpy()

    assert golden(img, reference(torch.float32))
    ctl = reference(torch.bfloat16)
    assert not golden(img, ctl)
    limits = bench.load(ROOT, CELL).cell["limits"]
    assert not check.judge(check.image_numbers(
        ctl.reshape(-1, 3), reference(torch.float32).reshape(-1, 3)),
        limits)[0]


def test_the_power_heuristic_matches_too():
    from tputracer_torch import api

    cfg = json.loads((ROOT / "perfbench" / "configs" / "cornell_caustic.json")
                     .read_text())
    arrays = scenes.build(cfg)
    r = dict(width=16, height=16, spp=4, max_bounces=3, chunk_size=1 << 12,
             mis_power=True)
    scene = program.build_scene(arrays, cfg, "cpu")
    img = api.render_bdpt(scene, KIND.render_config(r, 7))[0].numpy()
    cam = cfg["camera"]
    sc = ref_pt.make_ref_scene(arrays, eps=cfg["scene"]["eps"], device="cpu",
                               dtype=torch.float32)
    c = ref_pt.camera(cam["o"], cam["look_at"], cam["up"], cam["vfov_deg"],
                      cam["aspect"], "cpu", torch.float32)
    assert golden(img, ref_bdpt.render_image(sc, c, r, 7, power=True)
                  .numpy())


def test_flat_rays_are_benchmarks_runs_count():
    spec = bench.load(ROOT, CELL)
    assert KIND.flat_rays(spec.traffic) == 512 * 512 * 16 * 30 \
        == 125_829_120
    r = spec.traffic["render"]
    B = r["max_bounces"]
    # benchmarks/run.py: 2 (B + 1) walk segments and one ray a strategy
    n_strat = sum(1 for t in range(1, B + 3) for s in range(0, B + 2)
                  if 2 <= s + t <= B + 2 and not (s == 0 and t < 2))
    assert 2 * (B + 1) + n_strat == 30


def test_the_cell_is_found_by_name():
    spec = bench.load(ROOT, CELL)
    assert spec.kind.__module__ == "perfbench.kinds.bdpt_turntable"
    assert issubclass(spec.kind, bench.kind("turntable"))
    assert spec.config["name"] == "cornell_caustic"
    arrays = scenes.build(spec.config)
    assert arrays.tris.shape[0] == spec.config["n_triangles"] == 12
    assert len(arrays.spheres) == 1 and KIND.emitters(arrays) == [10, 11]
    assert {m["name"] for m in spec.end_to_end} == {
        "rays_per_s", "frame_ms_p95", "setup_s"}
    assert {m["name"] for m in spec.per_layer} == {
        "kernels_per_frame", "idle_pct.render", "replay_device_ms",
        "b1_roofline_pct", "bdpt_walk_device_ms", "bdpt_connect_device_ms",
        "bdpt_splat_device_ms"}
    assert spec.traffic["render"]["chunk_size"] == 1 << 20


def test_the_scene_is_the_ports_caustic_box():
    from tputracer_torch.scene import cornell_box

    spec = bench.load(ROOT, CELL)
    ours = program.build_scene(scenes.build(spec.config), spec.config, "cpu")
    port = cornell_box("caustic", device="cpu")
    for f in ("tri_v0", "tri_e1", "tri_e2", "tri_mat", "sph_c", "sph_r",
              "sph_mat", "mat_kind", "mat_albedo", "mat_emission", "mat_ior",
              "emit_prim"):
        assert torch.equal(getattr(ours, f), getattr(port, f)), f
    for f in ("o", "corner", "du", "dv"):
        assert torch.equal(getattr(ours.camera, f),
                           getattr(port.camera, f)), f


def test_the_phase_readers_read_none_without_phase_times():
    """A program whose replays time no phase (one older than them) reads
    None, and one that does reads the sum of its phases."""
    from tputracer_torch import trace

    trace.reset()
    for i in range(3):
        with trace.span("graphs.launch") as rec:
            pass
        rec.device = {"wait_ms": 0.01, "replay_ms": 10.0}
    st = type("S", (), {"kind": "render", "steps_per_unit": 1,
                        "host": {"unit_s": [0.1] * 3}})
    names = ("bdpt_walk_device_ms", "bdpt_connect_device_ms",
             "bdpt_splat_device_ms")
    assert [bench.reader(n)(st) for n in names] == [None] * 3
    for rec in trace.records("graphs.launch"):
        rec.device.update({"bdpt.eye_walk": 1.0, "bdpt.light_walk": 2.0,
                           "bdpt.s0": 0.5, "bdpt.connect": 4.0,
                           "bdpt.splat": 1.5})
    assert [bench.reader(n)(st) for n in names] == [3.0, 4.5, 1.5]
    trace.reset()


def test_the_cells_set_up_imports_no_jax():
    out = run_blocked(("jax", "jaxlib", "flax", "optax", "tputracer"), f"""
        import json, torch
        from perfbench import bench, run
        spec = bench.load({str(ROOT)!r}, {CELL!r})
        spec.traffic["render"].update(width=8, height=8, spp=1,
                                      chunk_size=64)
        r = spec.kind(spec, 3, torch.device("cpu"))
        r.setup()
        mods = {{m.split(".")[0] for m in sys.modules}}
        print(json.dumps([run.barred_modules(),
                          "tputracer_torch" in mods]))
    """)
    assert out.strip().splitlines()[-1] == '[[], true]'


def test_the_reference_imports_nothing_of_the_program():
    out = run_blocked(("jax", "jaxlib", "flax", "optax", "tputracer",
                       "tputracer_torch"), """
        import json, torch
        from perfbench import scenes
        from perfbench.reference import bdpt, pt
        cfg = json.load(open("perfbench/configs/cornell_caustic.json"))
        arrays = scenes.build(cfg)
        sc = pt.make_ref_scene(arrays, eps=1e-4, device="cpu",
                               dtype=torch.float32)
        c = cfg["camera"]
        cam = pt.camera(c["o"], c["look_at"], c["up"], c["vfov_deg"],
                        c["aspect"], "cpu", torch.float32)
        r = dict(width=8, height=8, spp=1, max_bounces=2, mis_power=False)
        print(float(bdpt.render_image(sc, cam, r, 1).mean()) > 0)
    """)
    assert out.strip().splitlines()[-1] == "True"


def small_spec():
    spec = bench.load(ROOT, CELL)
    spec.traffic = json.loads(json.dumps(spec.traffic))
    spec.traffic["render"].update(width=16, height=16, spp=2,
                                  chunk_size=16 * 2 * 4)
    spec.traffic["check"].update(frames=3)
    spec.traffic["traced_frames"] = 2
    return spec


def run(trace=False):
    return drive.run(small_spec(), 2**31 + 4242, 0.5, trace,
                     torch.device("cpu"), time.perf_counter())


def test_a_sound_run_is_correct():
    out = run(trace=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["e2e"]["setup_s"] > 0 and out["e2e"]["rays_per_s"] > 0
    assert out["per_layer"]["idle_pct.render"] is not None


def answer_altered(monkeypatch):
    """The frame's image one percent off where the program makes it."""
    render = KIND.render
    monkeypatch.setattr(KIND, "render",
                        lambda sc, cfg: render(sc, cfg) * 1.01)


def state_unchanged(monkeypatch):
    """Each frame renders the set-up's scene: the camera and light edits
    never reach the program."""
    monkeypatch.setattr(program, "with_tables",
                        lambda scene, camera=None, **tables: scene)


def half_the_samples(monkeypatch):
    """The film averages the first half of each pixel's s = 0 and t >= 2
    samples only."""
    from tputracer_torch.integrators import bdpt

    def film(L, cfg, rows=None, flip=True):
        rows = cfg.height if rows is None else rows
        img = L.reshape(rows, cfg.width, cfg.spp, 3)[:, :, :cfg.spp // 2]
        img = img.mean(dim=2)
        return torch.flip(img, dims=(0,)) if flip else img

    monkeypatch.setattr(bdpt, "film_from_radiance", film)


def splats_dropped(monkeypatch):
    """The t = 1 strategies leave the film."""
    from tputracer_torch.integrators import bdpt

    splats = bdpt.t1_splats
    monkeypatch.setattr(bdpt, "t1_splats",
                        lambda *a, **k: splats(*a, **k) * 0.0)


@pytest.mark.parametrize("fault", [answer_altered, state_unchanged,
                                   half_the_samples, splats_dropped],
                         ids=lambda f: f.__name__)
def test_a_broken_render_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out = run()
    assert not out["correct"], out["checks"]
