"""tputracer_torch.lookup against tputracer.lookup.

The JAX package reads every small table as ``one_hot(idx, M) @ table``
and so takes its gradient as ``one_hot(idx, M)^T @ g``.  The port gathers
in the forward, which must give the same bits, and keeps that gradient:
a blocked one-hot matmul whose summation order does not depend on the
ids, in place of ``table[idx]``'s own backward (``IndexBackward0``).
Inputs come from numpy with a seed.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from tputracer import lookup as jax_lookup
from tputracer_torch import lookup
from tputracer_torch.api import _loss_l2
from tputracer_torch.config import BdptConfig, RenderConfig
from tputracer_torch.integrators.bdpt import render_bdpt
from tputracer_torch.integrators.pt import render_pt
from tputracer_torch.lights import sample_light
from tputracer_torch.scene import cornell_box

# M = 2048 at 10 M + 256 lanes takes three blocks of 8,192 in the backward
SIZES = [1, 6, 2048]
SHAPES = ["(M,)", "(M, 3)"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)


def inputs(m, shape, seed):
    """A float32 table in [0, 1), N = 10 M + 256 ids in [0, M) and weights
    in [0, 1) of the lookup's shape."""
    rng = np.random.default_rng(seed)
    n = 10 * m + 256
    tail = () if shape == "(M,)" else (3,)
    table = rng.uniform(size=(m,) + tail).astype(np.float32)
    idx = rng.integers(0, m, n).astype(np.int32)
    w = rng.uniform(size=(n,) + tail).astype(np.float32)
    return table, idx, w


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("m", SIZES)
def test_fetch_forward_is_jax_bit_for_bit(m, shape):
    """fetch without and with a gradient against JAX's one-hot product at
    HIGHEST precision: the same bits."""
    table, idx, _ = inputs(m, shape, seed=m)
    ref = np.asarray(jax_lookup.fetch(jnp.asarray(table), jnp.asarray(idx)))
    plain = lookup.fetch(torch.from_numpy(table), torch.from_numpy(idx))
    t = torch.from_numpy(table).requires_grad_()
    out = lookup.fetch(t, torch.from_numpy(idx))
    assert type(out.grad_fn).__name__ == "_OneHotFetchBackward"
    np.testing.assert_array_equal(plain.numpy(), ref)
    np.testing.assert_array_equal(out.detach().numpy(), ref)


@pytest.mark.parametrize("m", [6, 2048, 2049])
def test_fetch_int_is_jax_bit_for_bit(m):
    """fetch_int on an int32 table holding -1 and 2^20, below, at and above
    the threshold, against JAX's fetch_int (its float product rounds back
    to int, exact below 2^24)."""
    rng = np.random.default_rng(m)
    table = rng.integers(-5, 5, m).astype(np.int32)
    table[0], table[-1] = -1, 1 << 20
    idx = rng.integers(0, m, 4 * m).astype(np.int32)
    idx[:2] = 0, m - 1
    ref = np.asarray(jax_lookup.fetch_int(jnp.asarray(table),
                                          jnp.asarray(idx)))
    out = lookup.fetch_int(torch.from_numpy(table), torch.from_numpy(idx))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)


def test_above_the_threshold_is_the_plain_gather():
    """M = 2049 rows (one more than the threshold) and a 3-dim table take
    table[idx] with its own backward, as JAX's fetch gathers there; the
    values are JAX's."""
    table, idx, _ = inputs(2049, "(M, 3)", seed=5)
    t = torch.from_numpy(table).requires_grad_()
    out = lookup.fetch(t, torch.from_numpy(idx))
    assert type(out.grad_fn).__name__ == "IndexBackward0"
    np.testing.assert_array_equal(
        out.detach().numpy(),
        np.asarray(jax_lookup.fetch(jnp.asarray(table), jnp.asarray(idx))))
    cube = torch.rand((6, 2, 2), requires_grad=True)
    assert type(lookup.fetch(cube, torch.tensor([0, 5])).grad_fn
                ).__name__ == "IndexBackward0"


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("m", SIZES)
def test_gradient_matches_jax_grad(m, shape):
    """torch.autograd of sum(w * fetch(table, idx)) against jax.grad of the
    same sum through JAX's fetch: rtol 1e-6 (float32 sums in another
    order)."""
    table, idx, w = inputs(m, shape, seed=10 + m)
    t = torch.from_numpy(table).requires_grad_()
    loss = torch.sum(torch.from_numpy(w)
                     * lookup.fetch(t, torch.from_numpy(idx)))
    (g_t,) = torch.autograd.grad(loss, [t])
    g_j = np.asarray(jax.grad(lambda a: jnp.sum(
        jnp.asarray(w) * jax_lookup.fetch(a, jnp.asarray(idx))))(
            jnp.asarray(table)))
    assert np.abs(g_j).max() > 0.0
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=1e-6, atol=0.0)


def test_backward_repeats_its_bits_at_2p18_lanes():
    """Two backwards of 2^18 lanes into a (6, 3) table give the same bits:
    above torch's threading grain, where table[idx]'s own backward need
    not; and they sum what a float64 accumulate sums, at rtol 1e-6."""
    rng = np.random.default_rng(18)
    n = 1 << 18
    idx = torch.from_numpy(rng.integers(0, 6, n).astype(np.int32))
    g = torch.from_numpy(rng.uniform(size=(n, 3)).astype(np.float32))
    t = torch.from_numpy(rng.uniform(size=(6, 3)).astype(np.float32))
    t.requires_grad_()
    torch.set_num_threads(4)
    try:
        a, b = (torch.autograd.grad(lookup.fetch(t, idx), [t], g)[0]
                for _ in range(2))
    finally:
        torch.set_num_threads(2)
    assert torch.equal(a, b)
    ref = np.zeros((6, 3))
    np.add.at(ref, idx.numpy(), g.numpy().astype(np.float64))
    np.testing.assert_allclose(a.numpy(), ref, rtol=1e-6)


def test_backward_of_ids_outside_the_table_is_jax_vjp():
    """one_hot_vjp adds nothing for an id outside [0, M), as JAX's one-hot
    VJP (the forward never sees one: test_callers_keep_ids_in_range)."""
    idx = np.array([0, -1, 5, 6, 2, 5], np.int32)
    g = np.random.default_rng(3).uniform(size=(6, 3)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jax_lookup.fetch(a, jnp.asarray(idx)),
                     jnp.zeros((6, 3), jnp.float32))
    np.testing.assert_array_equal(
        lookup.one_hot_vjp(torch.from_numpy(idx).long(),
                           torch.from_numpy(g), 6).numpy(),
        np.asarray(vjp(jnp.asarray(g))[0]))


def test_backward_refuses_a_lowered_float32_matmul():
    """With float32 matmuls allowed to run in bf16 on the CPU the backward
    refuses, rather than return a gradient that depends on the switch."""
    t = torch.rand((6, 3), requires_grad=True)
    out = lookup.fetch(t, torch.tensor([0, 5, 5]))
    prev = torch.backends.mkldnn.matmul.fp32_precision
    torch.backends.mkldnn.matmul.fp32_precision = "bf16"
    try:
        with pytest.raises(RuntimeError, match="full float32"):
            out.sum().backward()
    finally:
        torch.backends.mkldnn.matmul.fp32_precision = prev


def reaches(node, leaves):
    """Whether an autograd graph node reaches an AccumulateGrad of one of
    ``leaves``."""
    seen, stack = set(), [node]
    while stack:
        n = stack.pop()
        if n is None or n in seen:
            continue
        seen.add(n)
        if any(getattr(n, "variable", None) is v for v in leaves):
            return True
        stack.extend(f for f, _ in n.next_functions)
    return False


def graph_nodes(root):
    seen, stack = set(), [root]
    while stack:
        n = stack.pop()
        if n is None or n in seen:
            continue
        seen.add(n)
        stack.extend(f for f, _ in n.next_functions)
    return seen


def test_grad_render_graph_has_no_index_backward_from_a_table():
    """The loss of a 16x16 grad_render on boxes (config 5's problem) reaches
    the albedo and emission tables through the one-hot backward only: no
    IndexBackward0 in its graph leads to either."""
    cfg = RenderConfig(width=16, height=16, spp=4, max_bounces=3,
                       rr_start=2)
    sc = cornell_box("boxes", device="cpu")
    with torch.no_grad():
        target, _ = render_pt(sc, cfg)
    p = {"mat_albedo": (sc.mat_albedo * 0.5).requires_grad_(),
         "mat_emission": (sc.mat_emission * 2.0).requires_grad_()}
    img, _ = render_pt(dataclasses.replace(sc, **p), cfg)
    nodes = graph_nodes(_loss_l2(img, target).grad_fn)
    names = [type(n).__name__ for n in nodes]
    assert names.count("_OneHotFetchBackward") >= 13
    for v in p.values():
        assert any(type(n).__name__ == "_OneHotFetchBackward"
                   and reaches(n, [v]) for n in nodes)
    leaks = [n for n in nodes if type(n).__name__ == "IndexBackward0"
             and reaches(n, list(p.values()))]
    assert not leaks


GRAD_TABLES = {
    "boxes": ("mat_albedo", "mat_emission", "tri_n", "emit_area"),
    "spheres": ("mat_ior", "mat_albedo", "sph_c", "sph_r", "emit_v0",
                "emit_e1", "emit_e2", "emit_n"),
}


@pytest.mark.parametrize("variant", sorted(GRAD_TABLES))
def test_render_bits_with_and_without_grad(variant):
    """A render whose tables need a gradient (every float lookup through
    the one-hot backward's Function) gives the image and stats bits of
    the same render under torch.no_grad()."""
    cfg = RenderConfig(width=16, height=16, spp=2, max_bounces=4)
    sc = cornell_box(variant, device="cpu")
    p = {k: getattr(sc, k).clone().requires_grad_()
         for k in GRAD_TABLES[variant]}
    img_g, stats_g = render_pt(dataclasses.replace(sc, **p), cfg)
    assert img_g.requires_grad
    with torch.no_grad():
        img, stats = render_pt(sc, cfg)
    assert torch.equal(img_g.detach(), img)
    for k in stats:
        assert torch.equal(stats_g[k], stats[k]), k


def test_callers_keep_ids_in_range(monkeypatch):
    """Every id the lookup sites pass lies in [0, M): a PT render of
    Cornell spheres (misses, spheres, mirror and glass) and a BDPT render
    of caustic, with each module's fetch and fetch_int checked, and
    sample_light at u0 = 1 (the emitter pick clamped to E - 1)."""
    seen = []

    def checked(fn):
        def wrap(table, idx, *a, **kw):
            seen.append(int(idx.numel()))
            assert int(idx.min()) >= 0 and int(idx.max()) < table.shape[0]
            return fn(table, idx, *a, **kw)
        return wrap

    for name in ("tputracer_torch.bsdf.bsdf", "tputracer_torch.lights",
                 "tputracer_torch.accel.bruteforce",
                 "tputracer_torch.integrators.bdpt"):
        mod = importlib.import_module(name)
        for fn in ("fetch", "fetch_int"):
            if hasattr(mod, fn):
                monkeypatch.setattr(mod, fn, checked(getattr(lookup, fn)))
    render_pt(cornell_box("spheres", device="cpu"),
              RenderConfig(width=12, height=12, spp=2, max_bounces=5))
    render_bdpt(cornell_box("caustic", device="cpu"),
                BdptConfig(width=8, height=8, spp=2, max_bounces=3,
                           chunk_size=128))
    sc = cornell_box("boxes", device="cpu")
    ones = torch.ones(4)
    y = sample_light(sc, ones, ones * 0.5, ones * 0.5)[0]
    assert bool(torch.isfinite(y).all())
    assert len(seen) > 100
