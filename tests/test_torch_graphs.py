"""The compiled render entry points (tputracer_torch.graphs, api's _jit
functions) on the CPU.

On the card each entry point replays a CUDA graph keyed on its static
arguments and the scene's layout; those tests are in test_torch_cuda.py
(``-k graph``).  Here: the key (equal for scenes that differ only in table
values, different for anything a capture depends on), the copy-in into a
graph's static scene, the entry points running the eager functions' bits
on CPU tensors without capturing, the progressive passes' tensor offset,
and _progressive_pass_jit against the JAX package's at the golden
tolerances of tests/golden/test_pt_vs_oracle.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from test_torch_pt import golden_compare
from test_torch_scene import jax_arrays
from tputracer.api import _progressive_pass_jit as jax_pass
from tputracer.config import RenderConfig as JaxRenderConfig
from tputracer.scene import cornell_box as jax_cornell_box
from tputracer_torch import api, graphs
from tputracer_torch.config import BdptConfig, RenderConfig
from tputracer_torch.integrators import bdpt
from tputracer_torch.integrators.pt import render_pt
from tputracer_torch.scene import cornell_box, mesh_scene, scene_from_numpy
from tputracer_torch.scene.types import (CAMERA_FIELDS, TENSOR_FIELDS,
                                         TREE_FIELDS)

CFG = RenderConfig(width=24, height=24, spp=4, max_bounces=4, rr_start=2,
                   seed=5)
BDPT_CFG = BdptConfig(width=24, height=24, spp=4, max_bounces=3, seed=5,
                      chunk_size=24 * 4 * 6)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _no_pairs(monkeypatch):
    monkeypatch.delenv("TPUTRACER_PAIRS", raising=False)


def bits(t):
    """A tensor's bytes, for bit-for-bit comparisons (NaNs included)."""
    flat = t.detach().reshape(-1)
    return flat.clone().view(torch.uint8) if flat.numel() else \
        torch.zeros((0,), dtype=torch.uint8)


def test_key_ignores_table_values():
    """A material edited in place, or replaced by a new tensor of the same
    shape, or a moved light keeps the key: no capture again, as an edited
    JAX pytree leaf reuses the compiled program."""
    scene = cornell_box("boxes", device="cpu")
    key = graphs.graph_key("_render_jit", CFG, scene)
    hash(key)
    edited = dataclasses.replace(
        scene, mat_albedo=scene.mat_albedo * 0.5,
        mat_emission=scene.mat_emission + 1.0,
        emit_v0=scene.emit_v0 + 0.25)
    assert graphs.graph_key("_render_jit", CFG, edited) == key
    scene.mat_albedo.mul_(0.5)
    assert graphs.graph_key("_render_jit", CFG, scene) == key


def _other(what, monkeypatch):
    """(name, static, scene, inputs) changed in one thing a capture
    depends on."""
    scene = cornell_box("boxes", device="cpu")
    off = torch.zeros((1,), dtype=torch.int64)
    if what == "shape":
        return "p", (2, CFG), cornell_box("spheres", device="cpu"), (off,)
    if what == "padding":
        grow = {f: torch.cat([getattr(scene, f)] * 2)
                for f in ("tri_v0", "tri_e1", "tri_e2", "tri_n", "tri_mat",
                          "tri_mask")}
        return "p", (2, CFG), dataclasses.replace(scene, **grow), (off,)
    if what == "cfg":
        return "p", (2, CFG.with_(seed=6)), scene, (off,)
    if what == "step":
        return "p", (4, CFG), scene, (off,)
    if what == "name":
        return "q", (2, CFG), scene, (off,)
    if what == "eps":
        return "p", (2, CFG), dataclasses.replace(scene, eps=2e-4), (off,)
    if what == "n_tris":
        return "p", (2, CFG), dataclasses.replace(
            scene, n_tris=scene.n_tris - 1), (off,)
    if what == "leaf_size":
        return "p", (2, CFG), dataclasses.replace(scene, leaf_size=64), (off,)
    if what == "input dtype":
        return "p", (2, CFG), scene, (off.to(torch.int32),)
    if what == "pairs":
        monkeypatch.setenv("TPUTRACER_PAIRS", "1")
        return "p", (2, CFG), scene, (off,)
    raise ValueError(what)


@pytest.mark.parametrize("what", ["shape", "padding", "cfg", "step", "name",
                                  "eps", "n_tris", "leaf_size", "input dtype",
                                  "pairs"])
def test_key_changes_with(what, monkeypatch):
    scene = cornell_box("boxes", device="cpu")
    off = torch.zeros((1,), dtype=torch.int64)
    key = graphs.graph_key("p", (2, CFG), scene, (off,))
    name, static, other, inputs = _other(what, monkeypatch)
    assert graphs.graph_key(name, static, other, inputs) != key


@pytest.mark.parametrize("variant", ["spheres", "mesh"])
def test_copy_in_gives_the_static_scene_the_callers_bits(variant):
    """static_like gives the layout (shapes, dtypes, the Python fields),
    copy_in the bits of every scene and camera tensor and input; the
    static tensors are the graph's own, never the caller's."""
    scene = (cornell_box("spheres", device="cpu") if variant == "spheres"
             else mesh_scene(subdiv=2, leaf_size=32, accel="cluster",
                             device="cpu"))
    off = torch.tensor([12], dtype=torch.int64)
    static = graphs.static_like(scene)
    static_off = (torch.empty_like(off),)
    n = graphs.copy_in(static, scene, static_off, (off,))
    assert n == (len(TENSOR_FIELDS) + len(TREE_FIELDS) + len(CAMERA_FIELDS)
                 + 1)
    assert (static.n_tris, static.eps, static.leaf_size) == \
        (scene.n_tris, scene.eps, scene.leaf_size)
    for a, b in zip(graphs.scene_tensors(static), graphs.scene_tensors(scene)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(bits(a), bits(b))
        assert a.data_ptr() != b.data_ptr() or a.numel() == 0
    assert torch.equal(static_off[0], off)
    assert graphs.graph_key("x", 1, static, static_off) == \
        graphs.graph_key("x", 1, scene, (off,))


def _eager_progressive(scene, cfg, body, spp_per_pass):
    return api._progressive_loop(
        scene, cfg, lambda off, step: body(scene, cfg, off, step),
        spp_per_pass, None, True, None)


@pytest.mark.parametrize("entry", ["render", "render_bdpt",
                                   "render_progressive",
                                   "render_bdpt_progressive"])
def test_cpu_entry_points_are_the_eager_functions(entry):
    """On CPU tensors the _jit functions run eagerly: the un-jitted
    functions' bits, and nothing captured."""
    scene = cornell_box("caustic" if "bdpt" in entry else "boxes",
                        device="cpu")
    captures = graphs.CAPTURES
    if entry == "render":
        img, stats = api.render(scene, CFG)
        ref, ref_stats = render_pt(scene, CFG)
    elif entry == "render_bdpt":
        img, stats = api.render_bdpt(scene, BDPT_CFG)
        ref, ref_stats = bdpt.render_bdpt(scene, BDPT_CFG)
    elif entry == "render_progressive":
        img, done = api.render_progressive(scene, CFG, spp_per_pass=3)
        ref, ref_done = _eager_progressive(scene, CFG, api._pt_pass, 3)
        stats, ref_stats = {"done": done}, {"done": ref_done}
    else:
        img, done = api.render_bdpt_progressive(scene, BDPT_CFG,
                                                spp_per_pass=2)
        ref, ref_done = _eager_progressive(scene, BDPT_CFG, api._bdpt_pass,
                                           2)
        stats, ref_stats = {"done": done}, {"done": ref_done}
    img, ref = torch.as_tensor(np.asarray(img)), torch.as_tensor(
        np.asarray(ref))
    assert torch.equal(bits(img), bits(ref))
    assert stats.keys() == ref_stats.keys()
    for k in stats:
        assert torch.equal(torch.as_tensor(stats[k]),
                           torch.as_tensor(ref_stats[k])), k
    assert graphs.CAPTURES == captures and not graphs.graphs()


@pytest.mark.parametrize("offset, step", [(0, 1), (3, 2), (6, 4)])
def test_pass_uids_tensor_offset_equals_the_integer_form(offset, step):
    cfg = RenderConfig(width=5, height=3, spp=10)
    t = api._pass_uids(cfg, torch.tensor([offset], dtype=torch.int64), step,
                       torch.device("cpu"))
    i = api._pass_uids(cfg, offset, step, torch.device("cpu"))
    want = np.array([p * cfg.spp + offset + s for p in range(15)
                     for s in range(step)], np.int64)
    assert t.dtype == torch.int64 and torch.equal(t, i)
    np.testing.assert_array_equal(t.numpy(), want)


def test_wants_grad_only_with_grad_enabled_and_a_grad_tensor():
    scene = cornell_box("boxes", device="cpu")
    assert not graphs._wants_grad(scene, ())
    leaf = dataclasses.replace(
        scene, mat_albedo=scene.mat_albedo.clone().requires_grad_())
    assert graphs._wants_grad(leaf, ())
    with torch.no_grad():
        assert not graphs._wants_grad(leaf, ())
    img, _ = api.render(leaf, CFG.with_(width=8, height=8))
    assert img.grad_fn is not None


@pytest.mark.parametrize("offset, step", [(0, 2), (2, 2), (1, 3)])
def test_progressive_pass_matches_jax(offset, step):
    """_progressive_pass_jit against the JAX package's on the same numpy
    scene, uids and pass: the film sums at the golden tolerances."""
    js = jax_cornell_box("boxes")
    ts = scene_from_numpy(jax_arrays(js), n_tris=js.n_tris, eps=js.eps,
                          leaf_size=js.leaf_size, device="cpu")
    kw = dict(width=24, height=24, spp=4, max_bounces=4, rr_start=2, seed=5)
    want = jax_pass(js, jnp.full((1,), offset, jnp.uint32), step,
                    JaxRenderConfig(**kw))
    got = api._progressive_pass_jit(
        ts, torch.full((1,), offset, dtype=torch.int64), step,
        RenderConfig(**kw))
    assert got.shape == (24, 24, 3) and got.dtype == torch.float32
    golden_compare(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("symbol, kernel", [
    ("_ZN12_GLOBAL__N_122fused_intersect_kernelEPKfS1_S1_S1_S1_S1_iS1_",
     "fused_intersect_kernel"),
    ("_ZN12_GLOBAL__N_115traverse_kernelILi32EEEvPKfS2_S2_S2_S2_PKi",
     "traverse_kernel"),
    ("void (anonymous namespace)::traverse_kernel<32>(float const*, "
     "float const*)", "traverse_kernel"),
    ("_ZN12_GLOBAL__N_113expand_kernelILi8ELi4EEEvPKfS2_S2_", "expand_kernel"),
    ("_ZN12_GLOBAL__N_115pairtest_kernelILi8ELi4EEEvPKfS2_",
     "pairtest_kernel"),
    ("(anonymous namespace)::fold_kernel(float const*, int const*, int)",
     "fold_kernel"),
    ("_ZN12_GLOBAL__N_115uniform3_kernelEPKxxjjxPf", "uniform3_kernel"),
    ("_ZN43_GLOBAL__N__db82ccb5_10_connect_cu_ac0437e222connect_prepare_"
     "kernelEPKxiiixPKiPKffPfS6_S6_S6_Ph", "connect_prepare_kernel"),
    ("(anonymous namespace)::connect_finish_kernel(long long const*, long "
     "long const*, int, int, int, long long, int, int const*, float const*, "
     "unsigned char const*, float*)", "connect_finish_kernel"),
    ("_ZN43_GLOBAL__N__db82ccb5_10_connect_cu_ac0437e220connect_table_"
     "kernelEPxNS_10TableChunkEi", "connect_table_kernel"),
    ("_ZN43_GLOBAL__N__db82ccb5_10_connect_cu_ac0437e220splat_prepare_"
     "kernelEPKxiixiiPKiPKfS5_S5_S5_S5_S5_S5_S5_S5_PfS6_S6_S6_PhPi",
     "splat_prepare_kernel"),
    ("(anonymous namespace)::splat_finish_kernel(long long const*, long "
     "long const*, int, int, long long, int, int const*, float const*, "
     "float const*, float const*, float const*, unsigned char const*, "
     "int const*, float*)", "splat_finish_kernel"),
    ("(anonymous namespace)::uniform3_kernel(long long const*, long long, "
     "unsigned int, unsigned int, long long, float*)", "uniform3_kernel"),
    ("_ZN12_GLOBAL__N_111walk_kernelE8WalkArgs", "walk_kernel"),
    ("(anonymous namespace)::walk_kernel(WalkArgs)", "walk_kernel"),
    ("_ZN2at6native29vectorized_elementwise_kernelILi4ENS0_11FillFunctorIfEE"
     "St5arrayIPcLm1EEEEviT0_T1_", None),
    ("void at::native::index_elementwise_kernel<128, 4>(long, "
     "at::native::gpu_index_kernel)", None),
    ("my_traverse_kernel_v2", None),
])
def test_kernel_of_names_the_wrappers_kernels(symbol, kernel):
    """A graph's kernel nodes and a trace's kernels are counted by kernel
    from their symbols: the port's kernels, mangled or demangled, by
    their own names only."""
    assert graphs.kernel_of(symbol) == kernel


def test_kernels_map_to_the_wrappers_launch_counters():
    """Every kernel a library of cuda_build declares, mangled or
    demangled, is one graphs.kernel_of names, and no two libraries
    declare the same kernel: the seven libraries' fourteen kernels, all
    but the connection table's fill counted in cuda_build.LAUNCHES."""
    from tputracer_torch import cuda_build, rng  # noqa: F401
    from tputracer_torch.accel import (intersect_cuda, pairs_cuda,  # noqa
                                       traverse_cuda)
    from tputracer_torch.integrators import bdpt_cuda, pt_cuda  # noqa: F401

    declared = [k for lib in cuda_build.LIBRARIES.values()
                for k in lib.kernels()]
    assert len(declared) == len(set(declared)) == 14
    assert sorted(cuda_build.LIBRARIES) == ["connect.cu", "intersect.cu",
                                            "pairs.cu", "pt.cu", "rng.cu",
                                            "traverse.cu", "walk.cu"]
    for k in declared:
        assert graphs.kernel_of(f"_ZN12_GLOBAL__N_1{len(k)}{k}Ev") == k
        assert graphs.kernel_of(f"(anonymous namespace)::{k}(int)") == k
    assert [k for k, c in cuda_build.kernels().items() if not c] == \
        ["connect_table_kernel"]
