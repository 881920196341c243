"""tputracer_torch.scene: the builders give the JAX package's arrays.

Every tensor of the port's Cornell variants and furnace must equal the
``np.asarray`` of the JAX scene's leaf of the same name, in dtype, shape
and every bit; ``scene_from_numpy`` must carry a JAX scene across intact.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tputracer.scene import cornell_box as jax_cornell_box
from tputracer.scene import furnace as jax_furnace
from tputracer_torch.scene import cornell_box, furnace, scene_from_numpy
from tputracer_torch.scene.types import CAMERA_FIELDS, TENSOR_FIELDS

VARIANTS = ["empty", "boxes", "spheres", "glass_sphere", "caustic"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)


def jax_arrays(js):
    """A JAX Scene's leaves as host arrays, keyed as scene_from_numpy wants."""
    arrays = {name: np.asarray(getattr(js, name)) for name in TENSOR_FIELDS}
    arrays["camera"] = {k: np.asarray(getattr(js.camera, k))
                        for k in CAMERA_FIELDS}
    return arrays


def assert_scene_equal(ts, js):
    for name in TENSOR_FIELDS:
        want = np.asarray(getattr(js, name))
        got = getattr(ts, name).numpy()
        assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=name)
    for k in CAMERA_FIELDS:
        want = np.asarray(getattr(js.camera, k))
        got = getattr(ts.camera, k).numpy()
        assert got.dtype == want.dtype, (k, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=f"camera.{k}")
    assert (ts.n_tris, ts.eps, ts.leaf_size) == (js.n_tris, js.eps,
                                                 js.leaf_size)
    assert (ts.n_tri_pad, ts.n_spheres, ts.n_emitters, ts.n_clusters) == (
        js.n_tri_pad, js.n_spheres, js.n_emitters, js.n_clusters)


def test_field_names_match():
    from tputracer.scene.types import Scene as JaxScene

    jax_fields = {f.name for f in dataclasses.fields(JaxScene)}
    assert set(TENSOR_FIELDS) | {"camera", "n_tris", "eps",
                                 "leaf_size"} == jax_fields


@pytest.mark.parametrize("variant", VARIANTS)
def test_cornell_matches_jax(variant):
    assert_scene_equal(cornell_box(variant, device="cpu"),
                       jax_cornell_box(variant))


def test_cornell_light_scale_and_aspect_match_jax():
    assert_scene_equal(cornell_box("boxes", aspect=1.5, light_scale=2.0,
                                   device="cpu"),
                       jax_cornell_box("boxes", aspect=1.5, light_scale=2.0))


def test_furnace_matches_jax():
    assert_scene_equal(furnace(albedo=0.4, device="cpu"),
                       jax_furnace(albedo=0.4))


@pytest.mark.parametrize("variant", ["boxes", "spheres"])
def test_scene_from_numpy_round_trip(variant):
    js = jax_cornell_box(variant)
    ts = scene_from_numpy(jax_arrays(js), n_tris=js.n_tris, eps=js.eps,
                          leaf_size=js.leaf_size, device="cpu")
    assert_scene_equal(ts, js)
    back = {name: getattr(ts, name).numpy() for name in TENSOR_FIELDS}
    back["camera"] = {k: getattr(ts.camera, k).numpy() for k in CAMERA_FIELDS}
    again = scene_from_numpy(back, n_tris=ts.n_tris, eps=ts.eps,
                             leaf_size=ts.leaf_size, device="cpu")
    assert_scene_equal(again, js)


def test_cluster_scenes_not_supported_yet():
    """Cluster-BVH scenes used to raise NotImplementedError; the port now
    builds them, tensor-equal to the JAX package's (more in
    tests/test_torch_bvh.py)."""
    ts = cornell_box("boxes", accel="cluster", leaf_size=16, device="cpu")
    assert ts.n_clusters > 0
    assert_scene_equal(ts, jax_cornell_box("boxes", accel="cluster",
                                           leaf_size=16))
