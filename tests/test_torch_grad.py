"""Path-tracing gradients of tputracer_torch against tputracer's.

Both packages draw the same counter-based random numbers, so on a
diffuse-only scene with Russian roulette off (rr_start > max_bounces) the
estimator is a smooth function of albedo and emission, and torch.autograd
must match jax.grad to float32 noise, and the port's own AD must match
central finite differences (tests/unit/test_grad.py's setup and
tolerances).  Glass IOR gradients replay the decisions of the
linearization point through ``decision_scene``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from tputracer.api import grad_render as jax_grad_render
from tputracer.config import RenderConfig as JaxRenderConfig
from tputracer.integrators.pt import render_pt as jax_render_pt
from tputracer.scene import cornell_box as jax_cornell_box
from tputracer_torch.api import grad_render
from tputracer_torch.config import RenderConfig
from tputracer_torch.integrators.pt import render_pt
from tputracer_torch.scene import cornell_box

# tests/unit/test_grad.py's config: RR off keeps the FD pathwise-smooth
CFG = dict(width=16, height=16, spp=4, max_bounces=3, rr_start=99,
           chunk_size=16 * 16 * 4)
# its IOR case: glass needs more bounces to reach the light
IOR_CFG = dict(CFG, width=24, height=24, max_bounces=5,
               chunk_size=24 * 24 * 4)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)


def projection(cfg, seed):
    """Fixed random per-pixel weights: a weighted sum exercises every
    pixel with distinct weights (a mean would cancel antisymmetric
    errors)."""
    return np.random.default_rng(seed).uniform(
        size=(cfg["height"], cfg["width"], 3)).astype(np.float32)


def start_point(scene, name):
    """The linearization point: albedo away from 0 and 1, where the
    liveness test thr > 0 and the projection would straddle a kink."""
    p = getattr(scene, name)
    return torch.clamp(p, 0.05, 0.95) if name == "mat_albedo" else p


def torch_loss(scene, name, cfg, w, decisions):
    def f(p):
        img, _ = render_pt(dataclasses.replace(scene, **{name: p}),
                           RenderConfig(**cfg),
                           decision_scene=scene if decisions else None)
        return torch.sum(img * torch.from_numpy(w))
    return f


CASES = [("boxes", "mat_albedo", CFG), ("boxes", "mat_emission", CFG),
         ("spheres", "mat_ior", IOR_CFG)]
IDS = ["albedo", "emission", "ior"]


@pytest.mark.parametrize("variant, name, cfg", CASES, ids=IDS)
def test_grads_match_jax_grad(variant, name, cfg):
    """torch.autograd of the projected image against jax.grad of the same
    loss on the same scene arrays: rtol 1e-4 with atol 1e-6 of the largest
    entry (float32 sums in another order; no decision may differ)."""
    ts, js = cornell_box(variant, device="cpu"), jax_cornell_box(variant)
    w = projection(cfg, seed=3)
    decisions = name == "mat_ior"
    p0 = start_point(ts, name).clone().requires_grad_()
    (g_t,) = torch.autograd.grad(torch_loss(ts, name, cfg, w, decisions)(p0),
                                 [p0])

    def f(p):
        img, _ = jax_render_pt(js.replace(**{name: p}), JaxRenderConfig(**cfg),
                               decision_scene=js if decisions else None)
        return jnp.sum(img * w)

    g_j = np.asarray(jax.grad(f)(jnp.asarray(p0.detach().numpy())))
    assert np.abs(g_j).max() > 1e-3, "gradient unexpectedly zero"
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=1e-4,
                               atol=1e-6 * np.abs(g_j).max())


@pytest.mark.parametrize("variant, name, cfg, eps, seed", [
    ("boxes", "mat_albedo", CFG, 2e-3, 7),
    ("boxes", "mat_emission", CFG, 2e-2, 7),
    ("spheres", "mat_ior", IOR_CFG, 1e-3, 11)], ids=IDS)
def test_ad_matches_central_fd(variant, name, cfg, eps, seed):
    """The port's AD along a random direction against central finite
    differences, within 2% (3% for IOR), as tests/unit/test_grad.py holds
    the JAX package; the IOR pair replays the decisions of p0."""
    scene = cornell_box(variant, device="cpu")
    f = torch_loss(scene, name, cfg, projection(cfg, seed=3),
                   decisions=name == "mat_ior")
    p0 = start_point(scene, name)
    u = torch.from_numpy(np.random.default_rng(seed).normal(
        size=tuple(p0.shape)).astype(np.float32))
    x = p0.clone().requires_grad_()
    (g,) = torch.autograd.grad(f(x), [x])
    ad = float(torch.sum(g * u))
    with torch.no_grad():
        fd = (float(f(p0 + eps * u)) - float(f(p0 - eps * u))) / (2 * eps)
    tol = 3e-2 if name == "mat_ior" else 2e-2
    assert abs(ad) > 1e-6, "gradient unexpectedly zero"
    assert abs(fd - ad) <= tol * max(abs(fd), abs(ad)), (fd, ad)


def test_decision_scene_identity():
    """decision_scene=scene is the identity: the same image bits."""
    scene = cornell_box("spheres", device="cpu")
    cfg = RenderConfig(**dict(CFG, max_bounces=4))
    a, _ = render_pt(scene, cfg)
    b, _ = render_pt(scene, cfg, decision_scene=scene)
    assert torch.equal(a, b)


def test_grad_render_matches_jax():
    """api.grad_render on config 5's problem at 16x16 (albedo x 0.5 and
    emission x 2 against the true scene's image, Russian roulette on)
    against tputracer.api.grad_render: the loss at rtol 1e-5, the
    gradients at rtol 1e-4 with atol 1e-6 of the largest entry; the
    result keeps the keys of params, on the scene's device, and keyword
    arguments override cfg."""
    kw = dict(width=16, height=16, spp=4, max_bounces=3, rr_start=2,
              chunk_size=1 << 16)
    ts, js = cornell_box("boxes", device="cpu"), jax_cornell_box("boxes")
    target, _ = render_pt(ts, RenderConfig(**kw))
    params = {"mat_albedo": (ts.mat_albedo * 0.5).numpy(),
              "mat_emission": (ts.mat_emission * 2.0).numpy()}
    loss, grads = grad_render(ts, params, target.numpy(),
                              RenderConfig(**dict(kw, seed=9)), seed=0)
    loss_j, grads_j = jax_grad_render(
        js, {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(target.numpy()), JaxRenderConfig(**kw))
    assert list(grads) == list(params) and loss.shape == ()
    assert loss.device == ts.device and not loss.requires_grad
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    for k in params:
        g_j = np.asarray(grads_j[k])
        assert grads[k].device == ts.device and np.abs(g_j).max() > 1e-3
        np.testing.assert_allclose(grads[k].numpy(), g_j, rtol=1e-4,
                                   atol=1e-6 * np.abs(g_j).max(), err_msg=k)


def counting(fn, calls):
    def hook(*args, **kw):
        calls.append(fn.__name__)
        return fn(*args, **kw)
    return hook


def test_remat_keeps_the_primal_and_recomputes_in_backward():
    """cfg.remat runs each bounce under torch.utils.checkpoint: the image
    keeps its bits, the gradients agree at rtol 1e-5, and the backward
    pass recomputes every bounce, so the intersection hooks are called
    twice as often as without it."""
    from tputracer_torch.accel import intersect, occluded

    scene = cornell_box("spheres", device="cpu")   # glass and mirror lobes
    base = RenderConfig(**CFG)
    params = {"mat_albedo": torch.clamp(scene.mat_albedo, 0.05, 0.95),
              "mat_emission": scene.mat_emission}
    out = {}
    for remat in (False, True):
        calls = []
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        img, _ = render_pt(dataclasses.replace(scene, **p),
                           base.with_(remat=remat),
                           intersect_fn=counting(intersect, calls),
                           occluded_fn=counting(occluded, calls))
        forward_calls = len(calls)
        grads = torch.autograd.grad(torch.mean(img ** 2), list(p.values()))
        out[remat] = (img, grads, forward_calls, len(calls))
    img0, g0, fwd0, all0 = out[False]
    img1, g1, fwd1, all1 = out[True]
    assert torch.equal(img0, img1)
    bounce_calls = 2 * base.max_bounces + 1
    assert fwd0 == fwd1 == all0 == bounce_calls
    assert all1 == 2 * bounce_calls
    for a, b in zip(g0, g1):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-7)


def test_grad_step_nan_free():
    """A gradient step with MIS on the spheres scene (albedo, emission and
    IOR) under detect_anomaly(check_nan=True): a NaN made anywhere in the
    backward pass, even in a masked lane, raises (the t_safe and
    sqrt-clamp guards)."""
    scene = cornell_box("spheres", device="cpu")
    cfg = RenderConfig(width=12, height=12, spp=2, max_bounces=4, rr_start=2,
                       chunk_size=12 * 12 * 2)
    target, _ = render_pt(scene, cfg)
    params = {"mat_albedo": scene.mat_albedo * 0.7,
              "mat_emission": scene.mat_emission * 1.5,
              "mat_ior": scene.mat_ior}
    with torch.autograd.detect_anomaly(check_nan=True):
        loss, grads = grad_render(scene, params, target, cfg, mis=True)
    assert torch.isfinite(loss)
    for k, g in grads.items():
        assert bool(torch.isfinite(g).all()), k
