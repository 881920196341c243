"""tputracer_torch's path tracer against tputracer's.

Both packages draw the same counter-based random numbers, so their images
agree pixel by pixel up to float32 noise plus rare decision flips.  The
renders are held to the golden tolerances of
tests/golden/test_pt_vs_oracle.py (mean rel < 5e-4, outlier share < 1%),
at its four configurations; the shading functions are compared one by one
on random inputs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from golden.tolerance import golden_compare
from tputracer import bsdf as jbsdf
from tputracer import lights as jlights
from tputracer.api import render as jax_render
from tputracer.bsdf.bsdf import _fresnel_dielectric as jax_fresnel
from tputracer.config import RenderConfig as JaxRenderConfig
from tputracer.scene import cornell_box as jax_cornell_box
from tputracer.scene.mesh import mesh_scene as jax_mesh_scene
from tputracer_torch import bsdf as tbsdf
from tputracer_torch import lights as tlights
from tputracer_torch.api import render
from tputracer_torch.bsdf.bsdf import _fresnel_dielectric
from tputracer_torch.config import RenderConfig
from tputracer_torch.integrators.pt import render_pt
from tputracer_torch.scene import cornell_box, mesh_scene


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)


GOLDEN = [
    ("boxes", dict(width=24, height=24, spp=4, max_bounces=4, rr_start=2,
                   seed=5)),
    ("spheres", dict(width=20, height=20, spp=4, max_bounces=5, rr_start=2,
                     seed=9)),
    ("boxes", dict(width=24, height=24, spp=4, max_bounces=4, rr_start=2,
                   seed=13, mis=True)),
    ("spheres", dict(width=20, height=20, spp=4, max_bounces=5, rr_start=2,
                     seed=17, mis=True)),
]


@pytest.mark.parametrize("variant, kw", GOLDEN,
                         ids=["boxes", "spheres", "boxes_mis", "spheres_mis"])
def test_render_matches_jax(variant, kw):
    img_j, stats_j = jax_render(jax_cornell_box(variant), JaxRenderConfig(**kw))
    img_t, stats_t = render(cornell_box(variant, device="cpu"),
                            RenderConfig(**kw))
    assert img_t.shape == (kw["height"], kw["width"], 3)
    assert img_t.dtype == torch.float32
    golden_compare(img_t.numpy(), np.asarray(img_j))
    for k in ("alive", "rays_closest", "rays_shadow"):
        np.testing.assert_allclose(stats_t[k].numpy(), np.asarray(stats_j[k]),
                                   rtol=1e-3, err_msg=k)


def test_render_chunking_is_invisible():
    """uids are global, so splitting the wavefront into chunks changes
    nothing."""
    cfg = RenderConfig(width=8, height=8, spp=2, max_bounces=3)
    a, _ = render(cornell_box("boxes", device="cpu"), cfg)
    b, _ = render(cornell_box("boxes", device="cpu"), cfg.with_(chunk_size=32))
    assert torch.equal(a, b)


def small_mesh():
    """A clustered mesh at golden scale: (port scene, JAX scene)."""
    ts = mesh_scene(subdiv=3, leaf_size=32, accel="cluster", device="cpu")
    assert ts.n_clusters > 8
    return ts, jax_mesh_scene(subdiv=3, leaf_size=32, accel="cluster")


@pytest.mark.parametrize("scene, option", [
    ("boxes", "sort_rays"), ("boxes", "remat"),
    ("mesh", "sort_rays"), ("mesh", "remat")])
def test_render_sort_rays_and_remat_keep_the_bits(scene, option):
    """sort_rays (ignored on Cornell boxes, a permuted wavefront on a
    clustered mesh) and remat render the bits of the plain render, stats
    included."""
    sc = (cornell_box("boxes", device="cpu") if scene == "boxes"
          else small_mesh()[0])
    cfg = RenderConfig(width=12, height=12, spp=2, max_bounces=4, rr_start=2,
                       seed=3)
    img_a, st_a = render(sc, cfg)
    img_b, st_b = render(sc, cfg.with_(**{option: True}))
    assert torch.equal(img_a, img_b) and float(img_a.mean()) > 1e-3
    for k in st_a:
        assert torch.equal(st_a[k], st_b[k]), k


def test_sort_rays_permutes_the_wavefront(monkeypatch):
    """On a clustered scene the sort really reorders the lanes that reach
    the intersector, dead lanes last, and the image still has the plain
    render's bits."""
    from tputracer_torch.accel import intersect
    ts, _ = small_mesh()
    cfg = RenderConfig(width=8, height=8, spp=2, max_bounces=3, seed=4)
    seen = []

    def isect(sc, o, d, tmin, tmax):
        seen.append(tmax.clone())
        return intersect(sc, o, d, tmin, tmax)

    plain, _ = render_pt(ts, cfg)
    img, _ = render_pt(ts, cfg.with_(sort_rays=True), intersect_fn=isect)
    assert torch.equal(img, plain)
    live = seen[1] > 0   # bounce 1 comes after the first sort
    assert not live.all() and bool(live[:int(live.sum())].all())


def test_sort_rays_render_matches_jax():
    """sort_rays on a clustered mesh against tputracer.api.render with
    sort_rays, at the golden tolerances, with equal per-bounce ray
    counts."""
    kw = dict(width=24, height=24, spp=4, max_bounces=4, rr_start=2, seed=5,
              sort_rays=True)
    ts, js = small_mesh()
    img_t, stats_t = render(ts, RenderConfig(**kw))
    img_j, stats_j = jax_render(js, JaxRenderConfig(**kw))
    golden_compare(img_t.numpy(), np.asarray(img_j))
    for k in ("alive", "rays_closest", "rays_shadow"):
        np.testing.assert_array_equal(stats_t[k].numpy(),
                                      np.asarray(stats_j[k]), err_msg=k)


def shading_inputs(n, seed, n_mat):
    r = np.random.default_rng(seed)

    def unit(k):
        v = r.normal(size=(k, 3)).astype(np.float32)
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    mat = r.integers(0, n_mat, n).astype(np.int32)
    u = r.uniform(size=(3, n)).astype(np.float32)
    return mat, unit(n), unit(n), unit(n), u


def both(*xs):
    return (tuple(jnp.asarray(x) for x in xs),
            tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in xs))


@pytest.mark.parametrize("variant", ["spheres", "boxes"])
def test_bsdf_functions_match_jax(variant):
    js, ts = jax_cornell_box(variant), cornell_box(variant, device="cpu")
    mat, n, wo, wi, u = shading_inputs(4000, seed=3, n_mat=js.mat_kind.shape[0])
    (jm, jn, jwo, jwi, ju), (tm, tn, two, twi, tu) = both(mat, n, wo, wi, u)

    def close(a, b, rtol=1e-5, atol=1e-6):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=rtol,
                                   atol=atol)

    close(jbsdf.emitted(js, jm, jn, jwi), tbsdf.emitted(ts, tm, tn, twi))
    close(jbsdf.eval_bsdf(js, jm, jn, jwo, jwi),
          tbsdf.eval_bsdf(ts, tm, tn, two, twi))
    close(jbsdf.pdf_bsdf(js, jm, jn, jwo, jwi),
          tbsdf.pdf_bsdf(ts, tm, tn, two, twi))
    np.testing.assert_array_equal(
        tbsdf.nee_nonspecular(ts, tm).numpy(),
        np.asarray(jbsdf.nee_nonspecular(js, jm)))

    for transport in (True, False):
        wj, gj, pj, dj = jbsdf.sample_bsdf(js, jm, jn, jwo, *ju,
                                           transport_radiance=transport)
        wt, gt, pt, dt = tbsdf.sample_bsdf(ts, tm, tn, two, *tu,
                                           transport_radiance=transport)
        close(wj, wt, atol=2e-6)
        close(gj, gt)
        close(pj, pt)
        np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))


def test_fresnel_matches_jax():
    r = np.random.default_rng(8)
    cos_i = r.uniform(0.0, 1.0, 5000).astype(np.float32)
    eta_i = np.where(r.uniform(size=5000) < 0.5, 1.0, 1.5).astype(np.float32)
    eta_t = np.where(eta_i == 1.0, 1.5, 1.0).astype(np.float32)
    fj, cj, tj = jax_fresnel(*(jnp.asarray(x) for x in (cos_i, eta_i, eta_t)))
    ft, ct, tt = _fresnel_dielectric(
        *(torch.from_numpy(x) for x in (cos_i, eta_i, eta_t)))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))


@pytest.mark.parametrize("variant", ["boxes", "caustic"])
def test_lights_match_jax(variant):
    js, ts = jax_cornell_box(variant), cornell_box(variant, device="cpu")
    u = np.random.default_rng(4).uniform(size=(3, 3000)).astype(np.float32)
    (ju,), (tu,) = both(u)
    outs_j = jlights.sample_light(js, *ju)
    outs_t = tlights.sample_light(ts, *tu)
    for name, a, b in zip(("y", "n_l", "le", "pdf_area", "prim", "mat"),
                          outs_j, outs_t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-7, err_msg=name)

    prim = np.random.default_rng(5).integers(
        -1, js.n_tri_pad + 2, 3000).astype(np.int32)
    prim[:4] = np.asarray(js.emit_prim)[[0, 1, 0, 1]]
    (jp,), (tp,) = both(prim)
    pdf_j, em_j = jlights.pdf_light_area(js, jp)
    pdf_t, em_t = tlights.pdf_light_area(ts, tp)
    np.testing.assert_array_equal(em_t.numpy(), np.asarray(em_j))
    np.testing.assert_allclose(pdf_t.numpy(), np.asarray(pdf_j), rtol=1e-6)
    assert em_t[:4].all()
