"""The plain reference against the program on the CPU: the same random
streams, and ``api.render``'s image at 24x24, 4 spp on both scenes, with
the control (the reference in bfloat16) failing the cells' limits."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import bench, check, generator, program, scenes
from perfbench.reference import pt as ref

ROOT = Path(__file__).resolve().parents[2]
CELLS = {"boxes_turntable": dict(max_bounces=4, rr_start=3, pixels=None),
         "mesh_turntable": dict(max_bounces=8, rr_start=3, pixels=24)}


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**33 + 3])
def test_pcg3d_streams_are_the_programs(seed):
    from tputracer_torch import rng

    uid = torch.cat([torch.arange(4096, dtype=torch.int64),
                     torch.tensor([2**31 - 1, 2**31, 2**32 - 1, 2**32 + 9])])
    for salt in (0, 3, 8 * 7 + 2):
        ours = ref.uniform3(uid, salt, seed, torch.float32)
        theirs = rng.uniform3(uid, salt, seed)
        for a, b in zip(ours, theirs):
            assert torch.equal(a, b)


def frame_inputs(cell, seed, k):
    spec = bench.load(ROOT, cell)
    arrays = scenes.build(spec.config)
    tt = generator.Turntable(spec.traffic, spec.config["camera"], seed)
    em = generator.material_tables(arrays.materials)["mat_emission"]
    return spec, arrays, em * tt.factor(k), tt.origins[tt.yaw_index(k)]


def program_image(spec, arrays, emission, origin, r, seed):
    scene = program.build_scene(arrays, spec.config, "cpu")
    scene = program.with_tables(
        scene, camera=program.camera(spec.config["camera"], origin, "cpu"),
        mat_emission=torch.as_tensor(emission))
    return program.render(scene, program.render_config(r, seed)).numpy()


@pytest.mark.parametrize("cell", list(CELLS))
def test_reference_matches_api_render(cell):
    seed, k = 2**31 + 99, 5
    p = CELLS[cell]
    spec, arrays, em, origin = frame_inputs(cell, seed, k)
    r = dict(width=24, height=24, spp=4, max_bounces=p["max_bounces"],
             rr_start=p["rr_start"], chunk_size=1 << 12)
    img = program_image(spec, arrays, em, origin, r, seed)
    assert img.mean() > 1e-2
    pixels = check.pixel_sample(r, p["pixels"], seed)
    readings = check.render_readings(
        arrays, spec.config, r, seed, [(k, img)], pixels,
        torch.device("cpu"), lambda _: em, lambda _: origin)
    limits = spec.cell["limits"]
    assert check.judge(readings[0], limits)[0], readings
    assert readings[0]["mean_rel"] < 1e-6 and readings[0]["bad_share"] == 0
    # the control: the reference in bfloat16 in the program's place
    ctl = check.reference_pixels(arrays, spec.config, r, seed, em, origin,
                                 pixels, torch.device("cpu"),
                                 torch.bfloat16)
    got = check.image_numbers(ctl, check.reference_pixels(
        arrays, spec.config, r, seed, em, origin, pixels,
        torch.device("cpu"), torch.float32))
    assert not check.judge(got, limits)[0], got


def test_fit_control_fails_the_fit_limits():
    from perfbench.reference import fit as ref_fit

    spec = bench.load(ROOT, "boxes_fit")
    tr = json.loads(json.dumps(spec.traffic))
    tr["render"].update(width=24, height=24)
    arrays = scenes.build(spec.config)
    refr = ref_fit.first_steps(arrays, spec.config, tr, 11, "cpu",
                               torch.float32, 3)
    assert refr["losses"][0] > refr["losses"][2] > 0
    ctl = ref_fit.first_steps(arrays, spec.config, tr, 11, "cpu",
                              torch.bfloat16, 3)
    numbers = check.fit_readings(ctl, refr)
    assert not check.judge(numbers, spec.cell["limits"])[0], numbers
    same = check.fit_readings(refr, refr)
    assert same == {"loss_gap": 0.0, "grad_gap": 0.0, "change_gap": 0.0}


def test_fit_readings_leave_out_leaves_with_no_gradient():
    refr = {"losses": [1.0], "grad": {"a": 1.0, "b": 2.0, "c": 1e-9},
            "change": {"a": 0.1, "b": 0.1, "c": 0.05}}
    prog = {"losses": [1.0], "grad": {"a": 1.0, "b": 2.0, "c": 1e-9},
            "change": {"a": 0.1, "b": 0.1, "c": 0.0}}
    assert check.fit_readings(prog, refr)["change_gap"] == 0.0
    prog["change"]["a"] = 0.0
    assert check.fit_readings(prog, refr)["change_gap"] == 1.0


def test_emitter_orders_are_the_arrays_and_its_reverse():
    assert check.emitter_orders(1) == [[0]]
    assert check.emitter_orders(3) == [[0, 1, 2], [2, 1, 0]]
    # a thousand emitters still give two orders to try, not n!
    assert len(check.emitter_orders(1000)) == 2


@pytest.mark.parametrize("n", [16, 400, 4096])
def test_probe_pixels_are_drawn_from_the_seed_and_never_judged(n):
    pixels = np.arange(0, 3 * n, 3)
    probe, judged = check.split_probe(pixels, 7)
    assert len(probe) == min(check.PROBE_PIXELS, n // 4)
    assert not set(probe) & set(judged)
    assert sorted(set(probe) | set(judged)) == list(pixels)
    assert np.array_equal(probe, check.split_probe(pixels, 7)[0])
    assert not np.array_equal(probe, check.split_probe(pixels, 8)[0])


def test_pixels_are_read_from_the_bottom_row():
    img = np.arange(2 * 3 * 3, dtype=np.float32).reshape(2, 3, 3)
    # pixel 0 is the bottom row's first: image row 1
    assert np.array_equal(check.program_pixels(img, np.array([0, 3]), 3),
                          np.stack([img[1, 0], img[0, 0]]))


def test_reference_lobes_and_spheres_match_api_render():
    """The reference's mirror, glass and sphere code against the program
    on the Cornell box with the port's two spheres (BASELINE config 2's
    scene), which no cell runs yet."""
    from perfbench import scenes as sc

    spec = bench.load(ROOT, "boxes_turntable")
    cfg = json.loads(json.dumps(spec.config))
    cfg["geometry"]["boxes"] = []
    arrays = sc.build(cfg)
    arrays = sc.SceneArrays(arrays.tris, arrays.tri_mat, arrays.materials,
                            spheres=(((0.30, 0.18, 0.35), 0.18, 5),
                                     ((0.70, 0.18, 0.65), 0.18, 4)))
    em = generator.material_tables(arrays.materials)["mat_emission"]
    origin = cfg["camera"]["o"]
    r = dict(width=20, height=20, spp=4, max_bounces=5, rr_start=2,
             chunk_size=1 << 12)
    seed = 9
    img = program_image(type("S", (), {"config": cfg}), arrays, em, origin,
                        r, seed)
    readings = check.render_readings(
        arrays, cfg, r, seed, [(0, img)], check.pixel_sample(r, None, seed),
        torch.device("cpu"), lambda _: em, lambda _: origin)
    assert readings[0]["mean_rel"] < 1e-5 and readings[0]["bad_share"] < 1e-2
