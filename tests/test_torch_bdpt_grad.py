"""BDPT gradients of tputracer_torch: AD against finite differences and
against jax.grad of the JAX package's render_bdpt.

tests/unit/test_bdpt_grad.py's setup: the RNG is keyed on the path uid, so
on a diffuse-only scene the BDPT estimator, its t=1 ``index_add_`` splat
and its MIS ratio chains included, is a smooth function of albedo and
emission, and the port's AD must match central FD tightly.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from tputracer.config import BdptConfig as JaxBdptConfig
from tputracer.integrators.bdpt import render_bdpt as jax_render_bdpt
from tputracer.scene import cornell_box as jax_cornell_box
from tputracer_torch.config import BdptConfig
from tputracer_torch.integrators.bdpt import (eye_subpaths, light_subpaths,
                                              render_bdpt, t1_splats)
from tputracer_torch.scene import cornell_box

CFG = dict(width=12, height=12, spp=2, max_bounces=3, chunk_size=12 * 12 * 2)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)


def projection(seed=0, cfg=CFG):
    """Fixed random per-pixel weights; they weight the t=1 splat image
    too, since render_bdpt returns the combined film."""
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        size=(cfg["height"], cfg["width"], 3)).astype(np.float32))


def loss_of(scene, name, cfg=CFG):
    w = projection(cfg=cfg)

    def f(p):
        img, _ = render_bdpt(dataclasses.replace(scene, **{name: p}),
                             BdptConfig(**cfg))
        return torch.sum(img * w)
    return f


def start_point(scene, name):
    p = getattr(scene, name)
    return torch.clamp(p, 0.05, 0.95) if name == "mat_albedo" else p


def ad(f, p0):
    x = p0.clone().requires_grad_()
    (g,) = torch.autograd.grad(f(x), [x])
    return g


@pytest.mark.parametrize("name, eps, seed", [("mat_albedo", 2e-3, 7),
                                             ("mat_emission", 2e-2, 11)],
                         ids=["albedo", "emission"])
def test_bdpt_ad_matches_central_fd(name, eps, seed):
    """AD along a random direction against central FD within 2%.  Seed 11
    for emission: seed 7's direction is nearly orthogonal to the emission
    gradient, which puts the FD in float32 noise (as in the JAX test)."""
    scene = cornell_box("boxes", device="cpu")
    f = loss_of(scene, name)
    p0 = start_point(scene, name)
    u = torch.from_numpy(np.random.default_rng(seed).normal(
        size=tuple(p0.shape)).astype(np.float32))
    a = float(torch.sum(ad(f, p0) * u))
    with torch.no_grad():
        fd = (float(f(p0 + eps * u)) - float(f(p0 - eps * u))) / (2 * eps)
    assert abs(a) > 1e-6, "BDPT gradient unexpectedly zero"
    assert abs(fd - a) <= 2e-2 * max(abs(fd), abs(a)), (fd, a)


def test_bdpt_emission_grad_exact_by_linearity():
    """The BDPT film is linear in mat_emission (Le enters every strategy
    once), so Euler's identity <grad f, p0> == f(p0) holds to 1e-4."""
    scene = cornell_box("boxes", device="cpu")
    f = loss_of(scene, "mat_emission")
    p0 = scene.mat_emission
    lhs = float(torch.sum(ad(f, p0) * p0))
    with torch.no_grad():
        rhs = float(f(p0))
    assert abs(lhs - rhs) <= 1e-4 * abs(rhs), (lhs, rhs)


def test_bdpt_splat_term_carries_gradient():
    """The t=1 light-tracing splat alone is differentiable in the emitter
    intensity: the gradient of the splat film's sum is finite and nonzero,
    which pins the backward of index_add_."""
    scene = cornell_box("boxes", device="cpu")
    cfg = BdptConfig(**CFG)
    uid = torch.arange(cfg.width * cfg.height * cfg.spp, dtype=torch.int64)

    def f(em):
        sc = dataclasses.replace(scene, mat_emission=em)
        return torch.sum(t1_splats(sc, cfg, light_subpaths(sc, uid, cfg),
                                   eye_subpaths(sc, uid, cfg)))

    g = ad(f, scene.mat_emission)
    assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 1e-6


def test_bdpt_grad_finite_with_delta_chains():
    """Glass and mirror spheres: delta lobes route through the MIS
    suppression; the albedo gradient stays finite and nonzero."""
    scene = cornell_box("spheres", device="cpu")
    cfg = BdptConfig(**dict(CFG, max_bounces=4))

    def f(a):
        img, _ = render_bdpt(dataclasses.replace(scene, mat_albedo=a), cfg)
        return torch.mean(img)

    g = ad(f, start_point(scene, "mat_albedo"))
    assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 1e-6


@pytest.mark.parametrize("name", ["mat_albedo", "mat_emission"],
                         ids=["albedo", "emission"])
def test_bdpt_grads_match_jax_grad(name):
    """torch.autograd of render_bdpt's projected image against jax.grad of
    the JAX package's render_bdpt on the same scene arrays: rtol 1e-4 with
    atol 1e-6 of the largest entry."""
    ts, js = cornell_box("boxes", device="cpu"), jax_cornell_box("boxes")
    p0 = start_point(ts, name)
    g_t = ad(loss_of(ts, name), p0).numpy()
    w = projection().numpy()

    def f(p):
        img, _ = jax_render_bdpt(js.replace(**{name: p}), JaxBdptConfig(**CFG))
        return jnp.sum(img * w)

    g_j = np.asarray(jax.grad(f)(jnp.asarray(p0.numpy())))
    assert np.abs(g_j).max() > 1e-3
    np.testing.assert_allclose(g_t, g_j, rtol=1e-4,
                               atol=1e-6 * np.abs(g_j).max())


def test_bdpt_grad_nan_free():
    """The BDPT backward on the caustics scene (glass sphere: MIS ratio
    chains, the splat's backward, the delta masks) under
    detect_anomaly(check_nan=True): a NaN made in a masked lane raises."""
    scene = cornell_box("caustic", device="cpu")
    cfg = BdptConfig(width=8, height=8, spp=2, max_bounces=3,
                     chunk_size=8 * 8 * 2)
    p = {"mat_albedo": start_point(scene, "mat_albedo").clone()
         .requires_grad_(),
         "mat_emission": scene.mat_emission.clone().requires_grad_()}
    with torch.autograd.detect_anomaly(check_nan=True):
        img, _ = render_bdpt(dataclasses.replace(scene, **p), cfg)
        loss = torch.mean(img)
        grads = torch.autograd.grad(loss, list(p.values()))
    assert torch.isfinite(loss)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
