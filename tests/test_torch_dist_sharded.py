"""tputracer_torch.dist.mesh: rays data-parallel over a gloo world of
processes on the CPU, against the port's single-process renders and the
JAX package's dist.mesh on its virtual devices.

One world of 4 ranks (tests/torch_dist_worker.py, mode "sharded") renders
at P = 4, on the (2, 2) mesh and on groups of 2 and 1 ranks, renders BDPT
and takes fit steps; the tests read what each rank saved.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax
import torch_dist_worker as W
from tputracer import dist as jdist
from tputracer.config import BdptConfig as JaxBdptConfig
from tputracer.config import RenderConfig as JaxRenderConfig
from tputracer.scene import cornell_box as jax_cornell_box
from tputracer_torch.api import _loss_and_grads, render
from tputracer_torch.config import BdptConfig, RenderConfig
from tputracer_torch.integrators.bdpt import render_bdpt
from tputracer_torch.scene import cornell_box


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sharded"))
    for rc, _, err in W.run_world("sharded", 4, out):
        assert rc == 0, err[-3000:]
    return [W.load(out, r) for r in range(4)]


def boxes():
    return cornell_box("boxes", device="cpu")


def golden_compare(img, ref):
    """tests/golden/test_pt_vs_oracle.py's tolerances."""
    rel = np.abs(img - ref) / (1.0 + np.abs(ref))
    assert float(rel.mean()) < 5e-4, f"mean rel err {rel.mean():.2e}"
    assert float((rel > 5e-3).mean()) < 0.01, "outlier share"
    assert img.mean() > 1e-3


@pytest.mark.parametrize("mesh, holders", [
    ("p1", [0]), ("p2", [0, 1]), ("p4", [0, 1, 2, 3]),
    ("p22", [0, 1, 2, 3])], ids=["P=1", "P=2", "P=4", "mesh (2, 2)"])
def test_render_sharded_is_api_render_bit_for_bit(ranks, mesh, holders):
    """The DP render has the bits of api.render, image and stats, on every
    rank of the mesh, whatever its size or shape."""
    ref, ref_stats = render(boxes(), RenderConfig(**W.PT))
    for r in holders:
        np.testing.assert_array_equal(ranks[r][f"{mesh}_img"], ref.numpy())
        for k, v in ref_stats.items():
            np.testing.assert_array_equal(ranks[r][f"{mesh}_{k}"], v.numpy(),
                                          err_msg=k)


def test_render_sharded_matches_jax(ranks):
    """Against JAX's render_sharded on make_mesh((4,)): the golden
    tolerances, the stats within rtol 1e-3."""
    img, stats = jdist.render_sharded(jax_cornell_box("boxes"),
                                      JaxRenderConfig(**W.PT),
                                      jdist.make_mesh((4,)))
    golden_compare(ranks[0]["p4_img"], np.asarray(img))
    for k in ("alive", "rays_closest", "rays_shadow"):
        np.testing.assert_allclose(ranks[0][f"p4_{k}"], np.asarray(stats[k]),
                                   rtol=1e-3, err_msg=k)


def test_render_bdpt_sharded_matches_jax(ranks):
    """render_bdpt_sharded: the same image on every rank, within float
    tolerance of the port's single-process render_bdpt (the splat's sums
    in another order) and at the golden tolerances of JAX's
    render_bdpt_sharded."""
    ref = render_bdpt(boxes(), BdptConfig(**W.BDPT))[0].numpy()
    for r in range(1, 4):
        np.testing.assert_array_equal(ranks[r]["bdpt_img"],
                                      ranks[0]["bdpt_img"])
    np.testing.assert_allclose(ranks[0]["bdpt_img"], ref, rtol=1e-5,
                               atol=1e-7)
    img = jdist.render_bdpt_sharded(jax_cornell_box("boxes"),
                                    JaxBdptConfig(**W.BDPT),
                                    jdist.make_mesh((4,)))
    golden_compare(ranks[0]["bdpt_img"], np.asarray(img))


def jax_params(scene):
    return {k: getattr(scene, k) * s for k, s in W.FIT_PARAMS}


def test_fit_step_sharded_matches_jax(ranks):
    """fit_step_sharded's loss and gradients against JAX's on the same
    target, rtol 1e-5; every rank holds the same bits."""
    sc = jax_cornell_box("boxes")
    params = jax_params(sc)
    target = jnp.asarray(ranks[0]["fit_target"])
    loss, grads = jdist.fit_step_sharded(sc.replace(**params), params, target,
                                         JaxRenderConfig(**W.PT),
                                         jdist.make_mesh((4,)))
    np.testing.assert_allclose(ranks[0]["fit_loss"], float(loss), rtol=1e-5)
    for k in params:
        g = np.asarray(grads[k])
        np.testing.assert_allclose(ranks[0][f"fit_grad_{k}"], g, rtol=1e-5,
                                   atol=1e-5 * np.abs(g).max(), err_msg=k)
        for r in range(1, 4):
            np.testing.assert_array_equal(ranks[r][f"fit_grad_{k}"],
                                          ranks[0][f"fit_grad_{k}"])


def test_fit_step_opt_sharded_matches_jax(ranks):
    """One Adam step (lr 5e-2) through fit_step_opt_sharded against JAX's
    fit_step_opt_sharded with optax.adam: loss and new tables, rtol 1e-5."""
    sc = jax_cornell_box("boxes")
    params = jax_params(sc)
    opt = optax.adam(5e-2)
    loss, new, _ = jdist.fit_step_opt_sharded(
        sc.replace(**params), params, jnp.asarray(ranks[0]["fit_target"]),
        JaxRenderConfig(**W.PT), jdist.make_mesh((4,)), opt,
        opt.init(params))
    np.testing.assert_allclose(ranks[0]["opt_loss"], float(loss), rtol=1e-5)
    for k in params:
        np.testing.assert_allclose(ranks[0][f"opt_{k}"], np.asarray(new[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_fit_step_bdpt_sharded_matches_single_process(ranks):
    """The sharded BDPT step's loss and gradients against the port's
    single-process BDPT gradients, rtol 1e-5 of the largest entry.  Each
    rank's light paths splat onto other ranks' rows; without the splat's
    all-reduce in the backward (own_splat_rows) these gradients miss
    those rows' share and this test fails."""
    scene = boxes()
    cfg = BdptConfig(**W.BDPT)
    p = {"mat_albedo": (scene.mat_albedo * 0.6).requires_grad_()}
    loss, grads = _loss_and_grads(render_bdpt, scene, p,
                                  torch.from_numpy(ranks[0]["bdpt_target"]),
                                  cfg)
    g = grads["mat_albedo"].numpy()
    np.testing.assert_allclose(ranks[0]["bdpt_fit_loss"], float(loss),
                               rtol=1e-5)
    for r in range(4):
        np.testing.assert_allclose(ranks[r]["bdpt_fit_grad_mat_albedo"], g,
                                   rtol=1e-5, atol=1e-5 * np.abs(g).max())
