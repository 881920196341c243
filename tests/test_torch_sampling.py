"""Closed-form checks of tputracer_torch's sampler and Fresnel term.

The port of tests/unit/test_sampling_analytic.py: a chi-square test and
the moments of the cosine-hemisphere sampler, and the dielectric Fresnel
term at normal incidence, at Brewster's angle, past total internal
reflection, under Snell's law and under reciprocity.
"""

import numpy as np
import torch

from tputracer_torch import geometry as g
from tputracer_torch.bsdf.bsdf import _fresnel_dielectric


def uniforms(n, seed):
    u = np.random.default_rng(seed).uniform(size=(2, n)).astype(np.float32)
    return torch.from_numpy(u[0]), torch.from_numpy(u[1])


def fresnel(cos_i, n1, n2):
    f, cos_t, tir = _fresnel_dielectric(
        torch.as_tensor(cos_i, dtype=torch.float32),
        torch.tensor(n1, dtype=torch.float32),
        torch.tensor(n2, dtype=torch.float32))
    return f.numpy(), cos_t.numpy(), tir.numpy()


def test_cosine_hemisphere_chi_square():
    """Samples follow p = cos(theta) / pi: chi-square over 10 x 8
    equal-probability (cos theta, phi) bins (z edges sqrt(k / 10)) below
    150 (79 degrees of freedom; P ~ 1e-6)."""
    n = 200_000
    d = g.cosine_sample_hemisphere(*uniforms(n, seed=9)).numpy()
    assert np.all(d[:, 2] >= 0.0)
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-5)
    kz, kp = 10, 8
    z_edges = np.sqrt(np.linspace(0.0, 1.0, kz + 1))
    zi = np.clip(np.searchsorted(z_edges, d[:, 2], side="right") - 1, 0,
                 kz - 1)
    phi = np.arctan2(d[:, 1], d[:, 0])
    pi_ = np.clip(((phi + np.pi) / (2 * np.pi) * kp).astype(int), 0, kp - 1)
    counts = np.zeros((kz, kp))
    np.add.at(counts, (zi, pi_), 1)
    expected = n / (kz * kp)
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 150.0, chi2


def test_cosine_hemisphere_moments():
    """E[cos theta] = 2/3 and E[cos^2 theta] = 1/2, within 2e-3."""
    z = g.cosine_sample_hemisphere(*uniforms(400_000, seed=10))[:, 2].numpy()
    assert abs(z.mean() - 2.0 / 3.0) < 2e-3
    assert abs((z ** 2).mean() - 0.5) < 2e-3


def test_fresnel_normal_incidence_closed_form():
    """F(0) = ((n1 - n2) / (n1 + n2))^2 to rtol 1e-6, cos_t = 1."""
    for n1, n2 in ((1.0, 1.5), (1.5, 1.0), (1.0, 2.4), (1.33, 1.0)):
        f, cos_t, tir = fresnel(1.0, n1, n2)
        assert not bool(tir)
        np.testing.assert_allclose(f, ((n1 - n2) / (n1 + n2)) ** 2,
                                   rtol=1e-6)
        np.testing.assert_allclose(cos_t, 1.0, atol=1e-5)


def test_fresnel_brewster_and_tir():
    """At Brewster's angle (n1 = 1) F = cos(2 theta_B)^2 / 2; dense to rare
    past the critical angle F is exactly 1."""
    n2 = 1.5
    theta_b = np.arctan(n2)
    f, _, tir = fresnel(np.cos(theta_b), 1.0, n2)
    np.testing.assert_allclose(f, 0.5 * np.cos(2 * theta_b) ** 2, rtol=1e-5)
    assert not bool(tir)
    theta_c = np.arcsin(1.0 / n2)
    f, _, tir = fresnel(np.cos(theta_c * 1.05), n2, 1.0)
    assert bool(tir) and float(f) == 1.0


def test_fresnel_snell_consistency_and_energy():
    """cos_t satisfies n1 sin(theta_i) = n2 sin(theta_t) (atol 2e-4), F
    lies in [0, 1], and F(theta_i; n1 -> n2) = F(theta_t; n2 -> n1)."""
    cos_i = np.linspace(0.01, 1.0, 200, dtype=np.float32)
    for n1, n2 in ((1.0, 1.5), (1.5, 1.0), (1.0, 2.4)):
        f, cos_t, tir = fresnel(cos_i, n1, n2)
        assert np.all((f >= 0.0) & (f <= 1.0))
        ok = ~tir
        sin_i = np.sqrt(1.0 - cos_i[ok] ** 2)
        sin_t = np.sqrt(np.maximum(1.0 - cos_t[ok] ** 2, 0.0))
        np.testing.assert_allclose(n1 * sin_i, n2 * sin_t, atol=2e-4)
        f_rev, _, _ = fresnel(cos_t[ok], n2, n1)
        np.testing.assert_allclose(f[ok], f_rev, atol=2e-4)
