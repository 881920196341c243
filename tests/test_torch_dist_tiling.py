"""tputracer_torch.dist.scene_shard: the geometry tiled over a gloo world
of processes on the CPU, rays round the ring, against the port's
replicated renders and the JAX package's dist.scene_shard.

One world of 4 ranks (tests/torch_dist_worker.py, mode "tiling") renders
tiled at P = 4 and on the (2, 2) mesh, renders the spheres scene and the
clustered caustic with BDPT, takes tiled and DP fit steps and a tiled fit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import torch_dist_worker as W
from tputracer import dist as jdist
from tputracer.config import RenderConfig as JaxRenderConfig
from tputracer.dist import scene_shard as jshard
from tputracer.scene.mesh import mesh_scene as jax_mesh_scene
from tputracer_torch.api import render
from tputracer_torch.config import BdptConfig, RenderConfig
from tputracer_torch.dist import scene_shard
from tputracer_torch.integrators.bdpt import render_bdpt
from tputracer_torch.scene import cornell_box, mesh_scene


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tiling"))
    for rc, _, err in W.run_world("tiling", 4, out):
        assert rc == 0, err[-3000:]
    return [W.load(out, r) for r in range(4)]


def small_mesh():
    return mesh_scene(subdiv=4, leaf_size=32, accel="cluster", device="cpu")


@pytest.mark.parametrize("P", [3, 4, 8])
def test_pad_scene_clusters_equals_jax(P):
    """pad_scene_clusters is tensor-equal to JAX's, field by field."""
    mine = scene_shard.pad_scene_clusters(small_mesh(), P)
    ref = jshard.pad_scene_clusters(
        jax_mesh_scene(subdiv=4, leaf_size=32, accel="cluster"), P)
    assert mine.n_clusters == ref.n_clusters and mine.n_clusters % P == 0
    for f in scene_shard.TRI_FIELDS + ("plu", "clus_min", "clus_max",
                                       "emit_prim", "mat_albedo"):
        np.testing.assert_array_equal(getattr(mine, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)


def test_shard_footprint_is_c_over_p():
    """Each shard holds C/P clusters, their slots and boxes, a quarter of
    the geometry at P = 4; the shards together are the padded scene, and
    the rest of the scene stays whole."""
    P = 4
    padded = scene_shard.pad_scene_clusters(small_mesh(), P)
    tiles = [scene_shard.shard_scene(padded, r, P) for r in range(P)]
    for t in tiles:
        assert t.n_clusters == padded.n_clusters // P
        assert t.n_tri_pad == t.n_clusters * padded.leaf_size
        assert scene_shard.geometry_bytes(t) * P == \
            scene_shard.geometry_bytes(padded)
        assert t.mat_albedo is padded.mat_albedo
    for f in scene_shard.TRI_FIELDS + ("clus_min", "clus_max"):
        assert torch.equal(torch.cat([getattr(t, f) for t in tiles]),
                           getattr(padded, f)), f
    assert torch.equal(torch.cat([t.plu for t in tiles], dim=2), padded.plu)
    with pytest.raises(ValueError, match="pad_scene_clusters"):
        scene_shard.shard_scene(small_mesh(), 0, 7)


@pytest.mark.parametrize("mesh", ["p4", "p22"])
def test_render_tiled_matches_replicated_and_jax(ranks, mesh):
    """The tiled render against the port's replicated render (rtol 2e-5,
    atol 2e-6, the JAX tiling test's) and JAX's render_tiled (the golden
    tolerances), with equal ray counts; the same bits on every rank."""
    cfg = RenderConfig(**W.TILED)
    ref, ref_stats = render(small_mesh(), cfg)
    img = ranks[0][f"{mesh}_img"]
    np.testing.assert_allclose(img, ref.numpy(), rtol=2e-5, atol=2e-6)
    for k in ("rays_closest", "rays_shadow"):
        np.testing.assert_array_equal(ranks[0][f"{mesh}_{k}"],
                                      ref_stats[k].numpy(), err_msg=k)
    for r in range(1, 4):
        np.testing.assert_array_equal(ranks[r][f"{mesh}_img"], img)
    j_img, j_stats = jdist.render_tiled(
        jax_mesh_scene(subdiv=4, leaf_size=32, accel="cluster"),
        JaxRenderConfig(**W.TILED), jdist.make_mesh((4,)))
    rel = np.abs(img - np.asarray(j_img)) / (1.0 + np.abs(np.asarray(j_img)))
    assert float(rel.mean()) < 5e-4 and float((rel > 5e-3).mean()) < 0.01
    np.testing.assert_array_equal(ranks[0][f"{mesh}_rays_closest"],
                                  np.asarray(j_stats["rays_closest"]))
    assert int(ranks[0][f"{mesh}_ring_hops_per_traversal"]) == 4


def test_ring_bytes_equal_their_formula(ranks):
    """ring_ppermute_bytes_per_device: every intersection call sends its
    whole carry P times, 14 words a ray for the closest hit and 8 for
    occlusion: chunks x (closest calls x 56 + shadow calls x 32) x rays
    a chunk x P, at P = 4 and on the (2, 2) mesh alike."""
    cfg = RenderConfig(**W.TILED)
    P = 4
    n_loc = cfg.width * cfg.height * cfg.spp // P
    chunk = min(cfg.chunk_size, n_loc)
    want = (n_loc // chunk) * ((cfg.max_bounces + 1) * 56
                               + cfg.max_bounces * 32) * chunk * P
    for mesh in ("p4", "p22"):
        for r in range(4):
            assert float(ranks[r][f"{mesh}_ring_ppermute_bytes_per_device"]) \
                == want


def test_spheres_scene_global_ids(ranks):
    """cornell_box("spheres") in clusters of 4: the ring resolves the
    spheres at home with global ids P * T_loc + j, which are the whole
    padded scene's ids; its hits (prim, t, normal, material) are the
    whole scene's bit for bit, and the tiled render matches the
    replicated one with equal shadow-ray counts."""
    sph = cornell_box("spheres", accel="cluster", leaf_size=4, device="cpu")
    assert sph.n_spheres == 2 and sph.n_clusters > 0
    T = scene_shard.pad_scene_clusters(sph, 4).n_tri_pad
    seen_spheres = 0
    for r in range(4):
        z = ranks[r]
        valid = z["sph_whole_prim"] >= 0
        np.testing.assert_array_equal(z["sph_ring_prim"], z["sph_whole_prim"])
        np.testing.assert_array_equal(z["sph_ring_t"], z["sph_whole_t"])
        np.testing.assert_array_equal(z["sph_ring_n"][valid],
                                      z["sph_whole_n"][valid])
        np.testing.assert_array_equal(z["sph_ring_mat"], z["sph_whole_mat"])
        seen_spheres += int((z["sph_ring_prim"] >= T).sum())
    assert seen_spheres > 0
    cfg = RenderConfig(**W.SPHERES)
    ref, ref_stats = render(sph, cfg)
    np.testing.assert_allclose(ranks[0]["sph_img"], ref.numpy(), rtol=2e-5,
                               atol=2e-6)
    np.testing.assert_array_equal(ranks[0]["sph_rays_shadow"],
                                  ref_stats["rays_shadow"].numpy())


def test_render_bdpt_tiled_on_caustic(ranks):
    """render_bdpt_tiled on the clustered caustic (a glass sphere: delta
    chains through the ring's hits) against the replicated render_bdpt."""
    sc = cornell_box("caustic", accel="cluster", leaf_size=4, device="cpu")
    assert sc.n_spheres == 1 and sc.n_clusters > 0
    ref, _ = render_bdpt(sc, BdptConfig(**W.BDPT3))
    np.testing.assert_allclose(ranks[0]["bdpt_img"], ref.numpy(), rtol=2e-5,
                               atol=2e-6)


def test_fit_step_tiled_matches_fit_step_sharded(ranks):
    """The tiled step's loss and gradients against the DP step's and the
    JAX package's tiled step on the same target (the JAX tiling test's
    tolerances: loss rtol 1e-5, gradients rtol 2e-4)."""
    z = ranks[0]
    sc = jax_mesh_scene(subdiv=4, leaf_size=32, accel="cluster")
    params = {k: getattr(sc, k) * s for k, s in W.FIT_PARAMS}
    loss, grads = jdist.fit_step_tiled(sc.replace(**params), params,
                                       jnp.asarray(z["fit_target"]),
                                       JaxRenderConfig(**W.TILED),
                                       jdist.make_mesh((4,)))
    for ref_loss in (z["fit_dp_loss"], float(loss)):
        np.testing.assert_allclose(z["fit_tiled_loss"], ref_loss, rtol=1e-5,
                                   atol=1e-7)
    for k, _ in W.FIT_PARAMS:
        for ref in (z[f"fit_dp_grad_{k}"], np.asarray(grads[k])):
            np.testing.assert_allclose(z[f"fit_tiled_grad_{k}"], ref,
                                       rtol=2e-4, atol=1e-6, err_msg=k)


def test_fit_tiled_loss_falls(ranks):
    """fit(tiled=True) on the world: 4 steps in chains of 2, the loss
    falls, and every rank logs the same losses."""
    losses = ranks[0]["fit_tiled_losses"]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    for r in range(1, 4):
        np.testing.assert_array_equal(ranks[r]["fit_tiled_losses"], losses)


def test_cli_tiled_world_of_one(tmp_path, capsys):
    """python -m tputracer_torch.cli --tiled without torchrun: a world of
    one, the image of the replicated render."""
    from tputracer_torch import cli

    out = tmp_path / "tiled.png"
    cli.main(["--scene", "mesh_small", "--tiled", "--device", "cpu",
              "--size", "16", "--spp", "1", "--bounces", "2",
              "--out", str(out)])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    import json

    rec = json.loads(line)
    assert rec["tiled"] is True and out.exists()
    ref, _ = render(mesh_scene(subdiv=4, accel="cluster", device="cpu"),
                    RenderConfig(width=16, height=16, spp=1, max_bounces=2))
    assert rec["mean"] == float(ref.mean())
