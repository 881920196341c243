"""tputracer_torch.fit: inverse rendering on torch.autograd and Adam.

The fit recovers albedo and emission, a chain of steps equals the same
steps one at a time bit for bit, a resumed fit reproduces the
uninterrupted one bit for bit, BDPT fits, and a short trajectory matches
the JAX package's fit (optax.adam) at float tolerance.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tputracer import fit as jax_fit
from tputracer.config import RenderConfig as JaxRenderConfig
from tputracer.integrators.pt import render_pt as jax_render_pt
from tputracer.scene import cornell_box as jax_cornell_box
from tputracer_torch import fit as tfit
from tputracer_torch.config import BdptConfig, RenderConfig
from tputracer_torch.dist.mesh import Mesh
from tputracer_torch.integrators.bdpt import render_bdpt
from tputracer_torch.integrators.pt import render_pt
from tputracer_torch.scene import cornell_box

SMALL = dict(width=8, height=8, spp=2, max_bounces=2, rr_start=1,
             chunk_size=8 * 8 * 2)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)


def boxes():
    return cornell_box("boxes", device="cpu")


def problem(kw=SMALL):
    """(scene, cfg, target): the true scene's render is the target."""
    scene, cfg = boxes(), RenderConfig(**kw)
    return scene, cfg, render_pt(scene, cfg)[0]


def test_fit_recovers_albedo_and_emission():
    """40 Adam steps from a perturbed start cut the loss below 30% of its
    first value (tests/unit/test_grad.py's problem)."""
    scene, cfg, target = problem(dict(SMALL, width=16, height=16, spp=4,
                                      chunk_size=16 * 16 * 4))
    init = {"mat_albedo": torch.clamp(scene.mat_albedo * 0.4 + 0.2, 0.0, 1.0),
            "mat_emission": scene.mat_emission * 0.5}
    fitted, params, history = tfit.fit(scene, target, cfg=cfg, steps=40,
                                       learning_rate=1.5e-1, init=init,
                                       log_every=0)
    assert [h["step"] for h in history] == list(range(40))
    assert history[-1]["loss"] < 0.3 * history[0]["loss"], history[::8]
    assert torch.equal(fitted.mat_albedo, params["mat_albedo"])
    assert not params["mat_albedo"].requires_grad
    assert float(params["mat_albedo"].min()) >= 0.0
    assert float(params["mat_albedo"].max()) <= 1.0


def test_fit_chain_matches_stepwise():
    """K chained steps (one host read of the losses) equal K single steps,
    bit for bit: the same eager ops in the same order."""
    scene, cfg, target = problem()
    p0 = {"mat_albedo": scene.mat_albedo * 0.5}

    def fresh():
        p = {k: v.clone().requires_grad_() for k, v in p0.items()}
        return p, tfit._adam(list(p.values()), 5e-2)

    p, opt = fresh()
    step_losses = torch.stack([
        tfit._fit_step_single(scene, p, target, cfg, opt) for _ in range(4)])
    pc, opt_c = fresh()
    losses = tfit._fit_chain_single(scene, pc, target, cfg, opt_c, 4)
    assert losses.shape == (4,)
    assert torch.equal(losses, step_losses)
    assert torch.equal(pc["mat_albedo"], p["mat_albedo"])


def test_fit_checkpoint_resume_reproduces_trajectory(tmp_path):
    """A fit stopped at step 5 and resumed from its checkpoint equals the
    uninterrupted fit with the same checkpoint cadence, bit for bit: the
    parameters, Adam's state and every later loss."""
    scene, cfg, target = problem()
    init = {"mat_albedo": scene.mat_albedo * 0.5,
            "mat_emission": scene.mat_emission * 2.0}
    kw = dict(cfg=cfg, init=init, log_every=0, checkpoint_every=5,
              steps_per_dispatch=3)
    _, p_full, h_full = tfit.fit(scene, target, steps=10,
                                 checkpoint_path=str(tmp_path / "ref.npz"),
                                 **kw)
    ck = str(tmp_path / "fit.npz")
    tfit.fit(scene, target, steps=5, checkpoint_path=ck, **kw)
    with np.load(ck) as z:
        assert int(z["step"]) == 5
        assert [str(x) for x in z["names"]] == list(init)
        assert {"opt_0_step", "opt_0_exp_avg", "opt_1_exp_avg_sq"} <= set(
            z.files)
    _, p_res, h_res = tfit.fit(scene, target, steps=10, checkpoint_path=ck,
                               **kw)
    assert h_res[0]["step"] == 5
    assert [h["loss"] for h in h_res] == [h["loss"] for h in h_full[5:]]
    for k in init:
        assert torch.equal(p_full[k], p_res[k]), k


def test_checkpoint_of_other_parameters_refused(tmp_path):
    scene, cfg, target = problem()
    ck = str(tmp_path / "fit.npz")
    tfit.fit(scene, target, param_names=("mat_albedo",), cfg=cfg, steps=1,
             log_every=0, checkpoint_path=ck)
    with pytest.raises(ValueError, match="holds parameters"):
        tfit.fit(scene, target, cfg=cfg, steps=2, log_every=0,
                 checkpoint_path=ck)


def test_fit_bdpt_smoke():
    """fit(integrator="bdpt"): six Adam steps through the BDPT backward
    run and reduce the loss (tests/unit/test_bdpt_grad.py's problem)."""
    scene = boxes()
    cfg = BdptConfig(width=8, height=8, spp=2, max_bounces=2,
                     chunk_size=8 * 8 * 2)
    target, _ = render_bdpt(scene, cfg)
    off = {"mat_albedo": torch.clamp(scene.mat_albedo * 0.5, 0.05, 0.95)}
    _, _, hist = tfit.fit(scene, target, param_names=("mat_albedo",),
                          cfg=cfg, steps=6, learning_rate=5e-2, init=off,
                          log_every=0, steps_per_dispatch=3,
                          integrator="bdpt")
    assert np.isfinite(hist[-1]["loss"])
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_fit_trajectory_matches_jax():
    """Five steps against tputracer.fit.fit on the same start: losses at
    rtol 1e-5, parameters at atol 2e-5 (torch's Adam updates in another
    order of float operations than optax's; the renders agree to float32
    noise)."""
    scene, cfg, target = problem()
    js = jax_cornell_box("boxes")
    target_j, _ = jax_render_pt(js, JaxRenderConfig(**SMALL))
    init = {"mat_albedo": (scene.mat_albedo * 0.5).numpy(),
            "mat_emission": (scene.mat_emission * 2.0).numpy()}
    _, p_t, h_t = tfit.fit(scene, target, cfg=cfg, steps=5, init=init,
                           log_every=0)
    _, p_j, h_j = jax_fit.fit(js, target_j, cfg=JaxRenderConfig(**SMALL),
                              steps=5,
                              init={k: jnp.asarray(v) for k, v in init.items()},
                              log_every=0)
    np.testing.assert_allclose([h["loss"] for h in h_t],
                               [h["loss"] for h in h_j], rtol=1e-5)
    for k in init:
        np.testing.assert_allclose(p_t[k].numpy(), np.asarray(p_j[k]),
                                   rtol=0, atol=2e-5, err_msg=k)


def test_fit_custom_optimizer():
    """optimizer= takes a callable params_list -> torch.optim.Optimizer:
    one SGD step is p - lr * grad, projected."""
    from tputracer_torch.api import grad_render

    scene, cfg, target = problem()
    init = {"mat_albedo": scene.mat_albedo * 0.5}
    _, grads = grad_render(scene, init, target, cfg)
    _, params, _ = tfit.fit(scene, target, param_names=("mat_albedo",),
                            cfg=cfg, steps=1, init=init, log_every=0,
                            optimizer=lambda ps: torch.optim.SGD(ps, lr=0.5))
    want = torch.clamp(init["mat_albedo"] - 0.5 * grads["mat_albedo"], 0, 1)
    assert torch.equal(params["mat_albedo"], want)


@pytest.mark.parametrize("kw, error", [
    (dict(mesh=Mesh((3,), ("dp",), 0, 3, "gloo")), ValueError),
    (dict(mesh=Mesh((1,), ("dp",), 0, 1, "gloo"), tiled=True), ValueError),
    (dict(tiled=True), ValueError),
    (dict(integrator="mlt"), ValueError)],
    ids=["mesh", "tiled", "tiled without mesh", "unknown integrator"])
def test_fit_refuses_what_it_cannot_run(kw, error):
    """fit refuses, before any step: a mesh that does not divide the
    image's rows, tiling an unclustered scene, tiled=True without a mesh,
    an unknown integrator.  (The meshes are made without a world: the
    refusals come before any collective.)"""
    scene, cfg, target = problem()
    with pytest.raises(error):
        tfit.fit(scene, target, cfg=cfg, steps=1, log_every=0, **kw)


def test_fit_log_file_holds_one_line_a_step(tmp_path, capsys):
    """log_file gets one JSON line a step, equal to the history; log_every
    prints every that many steps."""
    scene, cfg, target = problem()
    log = tmp_path / "fit.jsonl"
    _, _, history = tfit.fit(scene, target, cfg=cfg, steps=5, log_every=2,
                             log_file=str(log), steps_per_dispatch=2)
    lines = [json.loads(x) for x in log.read_text().splitlines()]
    assert lines == history and [x["step"] for x in lines] == list(range(5))
    printed = capsys.readouterr().out.splitlines()
    assert [x.split(":")[0] for x in printed] == [
        "fit step 0", "fit step 2", "fit step 4"]
