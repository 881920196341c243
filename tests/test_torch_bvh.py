"""tputracer_torch's cluster BVH, mesh and OBJ builders against the JAX package's.

* build_clusters: the native SAH builder and the NumPy fallback
  (TPUTRACER_NO_NATIVE=1) each give exactly the JAX arrays (perm, mask,
  clus_min, clus_max).
* make_scene(accel="cluster") and mesh_scene are tensor-equal to the JAX
  scenes: every field in dtype, shape and every bit.
* The OBJ and MTL loaders give the JAX loaders' arrays and materials.
"""

import numpy as np
import pytest
import torch

from tputracer.accel.bvh import build_clusters as jax_build_clusters
from tputracer.scene import cornell_box as jax_cornell_box
from tputracer.scene.mesh import load_obj as jax_load_obj
from tputracer.scene.mesh import \
    load_obj_with_materials as jax_load_obj_with_materials
from tputracer.scene.mesh import mesh_scene as jax_mesh_scene
from tputracer.scene.mesh import obj_scene as jax_obj_scene
from tputracer.scene.types import make_camera as jax_make_camera
from tputracer.scene.types import make_scene as jax_make_scene
from tputracer_torch.accel import bvh
from tputracer_torch.api import render
from tputracer_torch.config import RenderConfig
from tputracer_torch.scene import (DIFFUSE, GLASS, MIRROR, cornell_box,
                                   load_obj, load_obj_with_materials,
                                   make_camera, make_scene, mesh_scene,
                                   obj_scene)
from tputracer_torch.scene.mesh import displaced_blob
from test_torch_scene import assert_scene_equal

OBJ = """
v 0 0 0
v 1 0 0
v 0 1 0
v 1 1 0
f 1 2 3
f 2 4 3
f -4 -3 -2 -1
"""

MTL = """
newmtl red
Kd 0.8 0.1 0.1
newmtl lamp
Kd 0 0 0
Ke 10 9 8
newmtl chrome
illum 5
Ks 0.95 0.95 0.95
newmtl glass
illum 7
Ni 1.52
d 0.1
"""

OBJ_MTL = """
v 0 0 0
v 1 0 0
v 0 1 0
v 1 1 0
usemtl red
f 1 2 3
usemtl lamp
f 2 4 3
usemtl chrome
f 1 3 2
usemtl glass
f 2 3 4
"""


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)


def random_soup(n_tris, seed):
    """The triangles and materials of tests/unit/test_accel.py::_random_scene."""
    r = np.random.default_rng(seed)
    base = r.uniform(-1, 1, (n_tris, 1, 3))
    tv = (base + r.uniform(-0.25, 0.25, (n_tris, 3, 3))).astype(np.float32)
    return tv, r.integers(0, 2, n_tris).astype(np.int32)


@pytest.mark.parametrize("builder", ["native", "numpy"])
@pytest.mark.parametrize("soup, leaf", [("random", 16), ("blob", 32),
                                        ("blob", 128)])
def test_build_clusters_matches_jax(builder, soup, leaf, monkeypatch):
    if builder == "numpy":
        monkeypatch.setenv("TPUTRACER_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("TPUTRACER_NO_NATIVE", raising=False)
    tv = random_soup(300, seed=4)[0] if soup == "random" else displaced_blob(4)
    got = bvh.build_clusters(tv, leaf_size=leaf)
    assert bvh.LAST_BUILDER == builder
    want = jax_build_clusters(tv, leaf_size=leaf)
    for name, a, b in zip(("perm", "mask", "clus_min", "clus_max"), got, want):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    perm, mask, cmin, cmax = got
    C = cmin.shape[0]
    assert C % 8 == 0 and perm.shape == (C * leaf,)
    # every triangle sits in exactly one real slot
    np.testing.assert_array_equal(np.sort(perm[mask > 0]),
                                  np.arange(tv.shape[0]))


def random_scene_both(n_tris=257, n_spheres=2, seed=0, leaf_size=16):
    """tests/unit/test_accel.py::_random_scene, built by both packages."""
    tv, mats = random_soup(n_tris, seed)
    materials = [
        {"kind": DIFFUSE, "albedo": (0.5, 0.5, 0.5)},
        {"kind": DIFFUSE, "albedo": (0, 0, 0), "emission": (5, 5, 5)},
    ]
    spheres = [((0.2, 0.1, 0.0), 0.3, 0),
               ((-0.4, -0.2, 0.3), 0.2, 1)][:n_spheres]
    cam = ((0, 0, -3), (0, 0, 0), (0, 1, 0), 40.0, 1.0)
    kw = dict(spheres=spheres, accel="cluster", leaf_size=leaf_size)
    return (make_scene(tv, mats, materials,
                       camera=make_camera(*cam, device="cpu"), device="cpu",
                       **kw),
            jax_make_scene(tv, mats, materials, camera=jax_make_camera(*cam),
                           **kw))


@pytest.mark.parametrize("n_spheres, leaf", [(2, 16), (0, 32)])
def test_make_scene_cluster_matches_jax(n_spheres, leaf):
    ts, js = random_scene_both(n_spheres=n_spheres, leaf_size=leaf, seed=3)
    assert ts.n_clusters > 8
    assert_scene_equal(ts, js)
    # padding slots are degenerate and point at material 0
    pad = ts.tri_mask == 0
    assert bool((ts.tri_v0[pad] == 0).all()) and bool((ts.tri_mat[pad] == 0)
                                                      .all())


@pytest.mark.parametrize("subdiv, leaf, accel", [(3, 32, "cluster"),
                                                 (4, 128, "auto")])
def test_mesh_scene_matches_jax(subdiv, leaf, accel):
    ts = mesh_scene(subdiv=subdiv, leaf_size=leaf, accel=accel, device="cpu")
    js = jax_mesh_scene(subdiv=subdiv, leaf_size=leaf, accel=accel)
    assert ts.n_clusters > 8
    assert_scene_equal(ts, js)


def test_mesh_scene_small_stays_unclustered_on_auto():
    """Below the 2,048-triangle threshold "auto" keeps brute force."""
    ts = mesh_scene(subdiv=2, device="cpu")
    assert ts.n_clusters == 0
    assert_scene_equal(ts, jax_mesh_scene(subdiv=2))


def test_cornell_cluster_matches_jax():
    assert_scene_equal(cornell_box("spheres", accel="cluster", leaf_size=16,
                                   device="cpu"),
                       jax_cornell_box("spheres", accel="cluster",
                                       leaf_size=16))


def test_obj_loader_roundtrip():
    tv = load_obj(OBJ)
    assert tv.shape == (4, 3, 3)       # 2 tris + 1 quad fan -> 2 tris
    np.testing.assert_allclose(tv[0, 1], [1, 0, 0])
    np.testing.assert_array_equal(tv, jax_load_obj(OBJ))
    np.testing.assert_array_equal(load_obj(OBJ, flip_winding=True),
                                  jax_load_obj(OBJ, flip_winding=True))
    scene = obj_scene(OBJ, accel="none", device="cpu")
    assert scene.n_tris == 4
    assert_scene_equal(scene, jax_obj_scene(OBJ, accel="none"))


def test_obj_mtl_materials():
    """usemtl/mtllib map onto the three BSDF families; emissive materials
    become area lights; the arrays and material lists equal JAX's."""
    tv, mats, materials = load_obj_with_materials(OBJ_MTL, mtl_source=MTL)
    assert tv.shape == (4, 3, 3)
    kinds = [materials[m]["kind"] for m in mats]
    assert kinds == [DIFFUSE, DIFFUSE, MIRROR, GLASS]
    assert materials[mats[1]]["emission"] == (10.0, 9.0, 8.0)
    assert abs(materials[mats[3]]["ior"] - 1.52) < 1e-6
    assert materials[mats[0]]["albedo"] == (0.8, 0.1, 0.1)
    jtv, jmats, jmaterials = jax_load_obj_with_materials(OBJ_MTL,
                                                         mtl_source=MTL)
    np.testing.assert_array_equal(tv, jtv)
    np.testing.assert_array_equal(mats, jmats)
    assert materials == jmaterials

    sc = obj_scene(OBJ_MTL, mtl_source=MTL, device="cpu")
    assert sc.n_emitters > 0
    assert_scene_equal(sc, jax_obj_scene(OBJ_MTL, mtl_source=MTL))
    img, _ = render(sc, RenderConfig(width=8, height=8, spp=2,
                                     max_bounces=2, chunk_size=128))
    assert bool(torch.isfinite(img).all())


def test_obj_files_with_mtllib(tmp_path):
    """A file path resolves its mtllib next to the OBJ, as in JAX."""
    (tmp_path / "m.mtl").write_text(MTL)
    obj = tmp_path / "m.obj"
    obj.write_text("mtllib m.mtl\n" + OBJ_MTL)
    tv, mats, materials = load_obj_with_materials(str(obj))
    jtv, jmats, jmaterials = jax_load_obj_with_materials(str(obj))
    np.testing.assert_array_equal(tv, jtv)
    np.testing.assert_array_equal(mats, jmats)
    assert materials == jmaterials
    assert [materials[m]["kind"] for m in mats] == [DIFFUSE, DIFFUSE, MIRROR,
                                                    GLASS]
    assert_scene_equal(obj_scene(str(obj), accel="cluster", leaf_size=16,
                                 device="cpu"),
                       jax_obj_scene(str(obj), accel="cluster", leaf_size=16))
