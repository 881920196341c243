"""The CUDA kernels against their plain versions, on the card.

The fused intersection kernel (csrc/intersect.cu), the cluster-BVH
traversal kernel (csrc/traverse.cu) and the pair route's expand and
pair-test kernels (csrc/pairs.cu) must agree bit for bit with their plain
torch versions, and renders through them with renders through the plain
versions (or, for the pair route, with the default route); BDPT too, its
per-path radiance bit for bit and its splat film at float tolerance;
gradients and fits (config 5) too, bit for bit; the compiled entry
points' CUDA graphs (graphs.py, ``-k graph``) against the eager renders,
bit for bit (BDPT's splat at float tolerance), edits seen without a new
capture, replays from other streams, and the launch counters after one
call; their spans: a replay's copy-in bytes, its device times from the
graph's event nodes, and the kernel census with those nodes in the
graph; the sampler kernel (csrc/rng.cu) against uniform3_plain bit for
bit, and graphed renders through it against those through the torch
sampler; BDPT's connection kernels (csrc/connect.cu, ``-k connect``)
against connection_radiance_plain bit for bit, graphed and eager, and a
BDPT gradient on the torch route; BDPT's splat kernels (the same source,
``-k splat``) against t1_splats_plain: the shadow-ray count bit for bit,
the film bit for bit where the splats land on distinct pixels and
elsewhere within the bound of its atomic sums' order, graphed and eager.
The ray sets and the splat's bound are chip_smoke.py's.

These tests need a CUDA card and skip without one. They import neither
JAX nor the JAX package, so they also run where JAX is not installed; on
the card, run them without the JAX-pinning conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import functools

import numpy as np
import pytest
import torch

from chip_smoke import (bounce_rays, box_soup, connect_launches, dead_rays,
                        face_rays, fallback_input, holey_tables, random_rays,
                        room_rays, run_rays, soup_rays, soup_scene,
                        splat_adds, splat_film_bound, splat_launches,
                        tie_pairs)
from tputracer_torch.accel import clustered as cl
from tputracer_torch.accel import intersect_cuda as ic
from tputracer_torch.accel import pairs
from tputracer_torch.accel import pairs_cuda as pc
from tputracer_torch.accel import traverse_cuda as tc
from tputracer_torch.accel import (intersect_clustered, intersect_plain,
                                   occluded_clustered, occluded_plain)
from tputracer_torch.api import render_bdpt, render_bdpt_progressive
from tputracer_torch.config import BdptConfig, RenderConfig
from tputracer_torch.cuda_build import LAUNCHES
from tputracer_torch.integrators.bdpt import trace_bdpt_rows
from tputracer_torch.integrators.pt import render_pt
from tputracer_torch.scene import cornell_box, make_scene, mesh_scene

BIG = 3.0e38
# the two intersection kernels' names in cuda_build.LAUNCHES
B1, B2 = "fused_intersect_kernel", "traverse_kernel"


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["boxes", "spheres"])
def test_cuda_kernel_matches_plain(variant):
    """Built with -fmad=false and summed in the plain version's order, the
    kernel gives the same t and prim bit for bit; a ragged ray count
    (not a multiple of the block) included."""
    need_card()
    args = ic.scene_args(cornell_box(variant, device="cuda"))
    o, d, tmin, tmax, tocc = random_rays(100_003, seed=7)
    launches = LAUNCHES[B1]
    t_k, p_k = ic.fused_intersect_cuda(o, d, tmin, tmax, *args)
    t_p, p_p = ic.fused_intersect_plain(o, d, tmin, tmax, *args)
    torch.cuda.synchronize()
    assert LAUNCHES[B1] == launches + 1
    assert torch.equal(p_k, p_p)
    assert torch.equal(t_k, t_p)
    assert torch.equal(t_k[p_k < 0], tmax[p_k < 0])
    zeros = torch.zeros_like(tocc)
    t_a, _ = ic.fused_intersect_cuda(o, d, zeros, tocc, *args, any_hit=True)
    t_q, _ = ic.fused_intersect_plain(o, d, zeros, tocc, *args)
    assert torch.equal(t_a < tocc, t_q < tocc)


@functools.lru_cache(maxsize=None)
def hard_case(name):
    """(closest-hit rays (o, d, tmin, tmax), any-hit rays, kernel tables)
    of one of the intersection kernel's hard cases, built once per test
    process."""
    if name == "bounce 2":
        sc = cornell_box("boxes", device="cuda")
        cfg = RenderConfig(width=64, height=64, spp=8, max_bounces=4)
        closest, shadow = bounce_rays(sc, cfg, 2)
        return closest, shadow, ic.scene_args(sc)
    if name == "holes":
        args = holey_tables(seed=31)
    elif name == "all dead":
        args = ic.scene_args(cornell_box("boxes", device="cuda"))
    else:
        n_tris, n_spheres = {"soup 300": (300, 0), "soup 2048": (2048, 0),
                             "spheres 300": (300, 300)}[name]
        args = ic.scene_args(make_scene(*box_soup(n_tris, n_spheres,
                                                  seed=35), device="cuda"))
    maker = dead_rays if name == "all dead" else random_rays
    o, d, tmin, tmax, tocc = maker(100_003, seed=36)
    return (o, d, tmin, tmax), (o, d, torch.zeros_like(tocc), tocc), args


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["holes", "soup 300", "soup 2048",
                                  "spheres 300", "bounce 2", "all dead"])
def test_cuda_kernel_hard_cases(case):
    """The kernel gives the plain version's t and prim bit for bit, and the
    same occlusion booleans with any hit: a mask with holes where every
    hit ties with a copy at a higher slot; more than 128 valid triangles
    (a ragged 300, and 2,048 in several staged tiles); 300 spheres in
    several tiles; the closest-hit and shadow rays of bounce 2 of a
    render; rays that are all dead."""
    need_card()
    closest, shadow, args = hard_case(case)
    launches = LAUNCHES[B1]
    t_k, p_k = ic.fused_intersect_cuda(*closest, *args)
    t_p, p_p = ic.fused_intersect_plain(*closest, *args)
    t_a, _ = ic.fused_intersect_cuda(*shadow, *args, any_hit=True)
    t_q, _ = ic.fused_intersect_plain(*shadow, *args)
    torch.cuda.synchronize()
    assert LAUNCHES[B1] == launches + 2
    assert torch.equal(p_k, p_p)
    assert torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))
    assert torch.equal(t_a < shadow[3], t_q < shadow[3])
    hit_share = float((p_p >= 0).float().mean())
    if case == "all dead":
        assert hit_share == 0.0 and torch.equal(t_k, closest[3])
    else:
        assert hit_share > 0.1
        assert 0.0 < float((t_q < shadow[3]).float().mean()) < 1.0
    if case == "holes":
        assert int(p_k.max()) < 192   # never the higher copy


@pytest.mark.cuda
def test_cuda_render_goes_through_kernel():
    """A render on the card launches the kernel 2*bounces+1 times per
    chunk and gives the image of the same render through the plain
    version."""
    need_card()
    sc = cornell_box("boxes", device="cuda")
    cfg = RenderConfig(width=32, height=32, spp=4, max_bounces=4)
    launches = LAUNCHES[B1]
    img_k, _ = render_pt(sc, cfg)
    torch.cuda.synchronize()
    assert LAUNCHES[B1] == launches + 2 * cfg.max_bounces + 1
    img_p, _ = render_pt(sc, cfg, intersect_fn=intersect_plain,
                         occluded_fn=occluded_plain)
    assert torch.equal(img_k, img_p)
    assert bool(torch.isfinite(img_k).all()) and float(img_k.mean()) > 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_traverse_kernel_matches_plain(any_hit):
    """The traversal kernel gives the plain walk's t and prim bit for bit
    at ~100k rays on mesh_scene(subdiv=4); with any_hit the same first
    hit, so the same occlusion booleans."""
    need_card()
    args = cl.traverse_args(mesh_scene(subdiv=4, device="cuda"))
    o, d, tmin, tmax, tocc = room_rays(100_003, seed=9)
    if any_hit:
        tmax = tocc
    bt0 = tmax.clone()
    bp0 = torch.full(tmax.shape, -1, dtype=torch.int32, device="cuda")
    launches = LAUNCHES[B2]
    t_k, p_k = tc.traverse_cuda(o, d, tmin, tmax, bt0, bp0, *args, leaf=128,
                                any_hit=any_hit)
    t_p, p_p = cl._traverse(o, d, tmin, tmax, bt0, bp0, *args, leaf=128,
                            any_hit=any_hit)
    torch.cuda.synchronize()
    assert LAUNCHES[B2] == launches + 1
    assert torch.equal(p_k, p_p)
    assert torch.equal(t_k, t_p)
    assert float((p_k >= 0).float().mean()) > 0.2
    assert torch.equal(t_k[::4], tmax[::4]) and bool((p_k[::4] == -1).all())


@pytest.mark.cuda
def test_traverse_kernel_spheres_small_leaf():
    """The sphere preamble and 16-slot leaves, at a ragged ray count."""
    need_card()
    sc = cornell_box("spheres", accel="cluster", leaf_size=16, device="cuda")
    o, d, tmin, tmax, tocc = (x[:1000] for x in random_rays(1000, seed=3))
    hk = tc.intersect_traverse(sc, o, d, tmin, tmax)
    hp = intersect_clustered(sc, o, d, tmin, tmax)
    assert torch.equal(hk.prim, hp.prim) and torch.equal(hk.t, hp.t)
    assert bool((hk.prim >= sc.n_tri_pad).any())      # spheres were hit
    assert torch.equal(tc.occluded_traverse(sc, o, d, tocc),
                       occluded_clustered(sc, o, d, tocc))


@pytest.mark.cuda
def test_cuda_mesh_render_goes_through_traversal_kernel():
    """A 32x32 mesh render on the card launches the traversal kernel
    2*bounces+1 times per chunk (never the fused kernel) and gives the
    image of the same render through the plain walk."""
    need_card()
    sc = mesh_scene(subdiv=4, device="cuda")
    cfg = RenderConfig(width=32, height=32, spp=4, max_bounces=8,
                       rr_start=3)
    launches, fused = LAUNCHES[B2], LAUNCHES[B1]
    img_k, _ = render_pt(sc, cfg)
    torch.cuda.synchronize()
    assert LAUNCHES[B2] == launches + 2 * cfg.max_bounces + 1
    assert LAUNCHES[B1] == fused
    img_p, _ = render_pt(sc, cfg, intersect_fn=intersect_clustered,
                         occluded_fn=occluded_clustered)
    assert torch.equal(img_k, img_p)
    assert bool(torch.isfinite(img_k).all()) and float(img_k.mean()) > 0.1


@functools.lru_cache(maxsize=None)
def walk_case(name):
    """(walk inputs (o, d, tmin, tmax, bt0, bp0), scene tables, leaf) of
    one of the hard ray sets, built once per test process."""
    if name == "deep":
        # every ray admits more than 4 x 32 of the soup's 128-slot
        # clusters, more than the lanes' buffers hold, so lanes refill them
        sc = soup_scene(20_480, seed=21)
        args = cl.traverse_args(sc)
        o, d, tmin, tmax, _ = soup_rays(2048, seed=22)
        te = cl.cluster_entries(o, d, tmin, tmax, args[0], args[1])
        assert int((te < BIG).sum(1).min()) > 4 * 32
    elif name == "faces":
        sc = mesh_scene(subdiv=4, device="cuda")
        args = cl.traverse_args(sc)
        o, d, tmin, tmax, _ = face_rays(args[0], args[1], 20_000, seed=22)
        te = cl.cluster_entries(o, d, tmin, tmax, args[0], args[1])
        assert float(((te == 0).sum(1) >= 2).float().mean()) > 0.5
    else:   # the pair route's fallback call: resolved rays at tmax = 0
        sc = mesh_scene(subdiv=4, device="cuda")
        walk_in, unresolved = fallback_input(sc, *room_rays(100_003,
                                                            seed=23)[:4])
        assert 0 < unresolved < 10_000
        return walk_in, cl.traverse_args(sc), sc.leaf_size
    bp0 = torch.full(tmax.shape, -1, dtype=torch.int32, device="cuda")
    return (o, d, tmin, tmax, tmax.clone(), bp0), args, sc.leaf_size


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["deep", "faces", "fallback"])
def test_traverse_kernel_hard_rays(case):
    """The traversal kernel gives the plain walk's t and prim bit for bit,
    closest and any hit, on deep walks (lanes refill their buffers), on
    entries that tie at te = +-0, and on the pair route's fallback input."""
    need_card()
    walk_in, args, leaf = walk_case(case)
    modes = (False,) if case == "fallback" else (False, True)
    for any_hit in modes:
        launches = LAUNCHES[B2]
        t_k, p_k = tc.traverse_cuda(*walk_in, *args, leaf=leaf,
                                    any_hit=any_hit)
        t_p, p_p = cl._traverse(*walk_in, *args, leaf=leaf, any_hit=any_hit)
        torch.cuda.synchronize()
        assert LAUNCHES[B2] == launches + 1
        assert torch.equal(p_k, p_p) and torch.equal(t_k, t_p)
        assert float((p_p >= 0).float().mean()) > 0.01


@functools.lru_cache(maxsize=None)
def pair_sets(leaf):
    """(mesh_scene(subdiv=4) in clusters of ``leaf`` slots, its ray sets as
    (o, d, tmin, tmax, tocc)): room rays at a ragged count; rays that are
    all dead; runs, whose pairs sort into long runs of one cluster beside
    runs of a single pair."""
    sc = mesh_scene(subdiv=4, leaf_size=leaf, device="cuda")
    return sc, {"room": room_rays(100_003, seed=11),
                "dead": dead_rays(20_000, seed=12),
                "runs": run_rays(sc, 30_000, 64, seed=13)}


def sets_for(any_hit, k):
    """Every (leaf, scene, set name, rays (o, d, tmin, tmax)) of pair_sets
    in one mode."""
    for leaf in (16, 128):
        sc, sets = pair_sets(leaf)
        for name, (o, d, tmin, tmax, tocc) in sets.items():
            if any_hit:
                tmin, tmax = torch.zeros_like(tocc), tocc
            yield leaf, sc, name, (o, d, tmin, tmax)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 4, 7, 9, 16])
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_expand_kernel_matches_plain(any_hit, k):
    """The expand kernel gives expand_plain's slots and bound bit for bit
    on mesh_scene(subdiv=4) in 16- and 128-slot clusters, for K in each of
    the kernel's three buffer sizes, on room rays (a ragged count), dead
    rays and runs; dead lanes get no slot."""
    need_card()
    for leaf, sc, name, rays in sets_for(any_hit, k):
        cmin, cmax = pairs.pairs_args(sc)[:2]
        launches = LAUNCHES["expand_kernel"]
        got = pc.expand_cuda(*rays, cmin, cmax, k=k)
        want = pairs.expand_plain(*rays, cmin, cmax, k=k)
        torch.cuda.synchronize()
        assert LAUNCHES["expand_kernel"] == launches + 1
        for a, b in zip(got, want):
            assert torch.equal(a, b), (leaf, name)
        dead = rays[3] <= rays[2]
        assert bool((got[0][dead] == -1).all()), (leaf, name)
        if name == "room" and k == 4:   # some rays admit more than K
            assert float((got[2] < BIG).float().mean()) > 0.01


def pair_inputs(sc, rays, k, seed):
    """pairtest_plain's arguments on one ray set: expand_plain's slots,
    their cluster order, and a best from elsewhere (bt0 below tmax, prim
    7) for a third of the rays, so their farther slots are not wanted."""
    o, d, tmin, tmax = rays
    cmin, cmax, v0, e1, e2, mask = pairs.pairs_args(sc)
    cid, te, _ = pairs.expand_plain(o, d, tmin, tmax, cmin, cmax, k=k)
    rng = np.random.default_rng(seed)
    near = torch.from_numpy(rng.uniform(size=o.shape[0]) < 1 / 3).cuda()
    bt = torch.from_numpy(rng.uniform(0.3, 3.0, o.shape[0]).astype(
        np.float32)).cuda()
    bt0 = torch.where(near, torch.minimum(bt, tmax), tmax)
    bp0 = torch.where(near, 7, -1).to(torch.int32)
    return (o, d, tmin, bt0, bp0, pairs.cluster_order(cid, sc.n_clusters),
            cid, te, v0, e1, e2, mask)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 4, 9, 16])
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_pairtest_kernel_matches_plain(any_hit, k):
    """The pair-test kernel gives pairtest_plain's folded t and p bit for
    bit, reading the slots through the cluster order, on every set of
    pair_sets in 16- and 128-slot clusters; and the constructed tie of
    chip_smoke.tie_pairs."""
    need_card()
    for leaf, sc, name, rays in sets_for(any_hit, k):
        args = pair_inputs(sc, rays, k, seed=14)
        launches = LAUNCHES["pairtest_kernel"]
        t_k, p_k = pc.pairtest_cuda(*args, leaf=leaf)
        t_p, p_p = pairs.pairtest_plain(*args, leaf=leaf)
        torch.cuda.synchronize()
        assert LAUNCHES["pairtest_kernel"] == launches + 1
        assert torch.equal(p_k, p_p), (leaf, name)
        assert torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))
        improved = int((t_p < args[3]).sum())
        if name == "dead":
            assert improved == 0 and torch.equal(p_k, args[4])
        else:
            assert improved > 100, (leaf, name)
    args, leaf, (want_t, want_p) = tie_pairs()
    t_k, p_k = pc.pairtest_cuda(*args, leaf=leaf)
    assert t_k.tolist() == want_t and p_k.tolist() == want_p


@pytest.mark.cuda
def test_pair_route_matches_traverse_kernel():
    """The whole pair route against the traversal kernel: t within 1e-6
    |t| plus four times the two triangle tests' rounding bounds (the slots
    test by Moeller-Trumbore, the walk by the plane equation), the same
    prim except where two hits tie to within that, and the same occlusion
    booleans."""
    need_card()
    sc = mesh_scene(subdiv=4, device="cuda")
    o, d, tmin, tmax, tocc = room_rays(100_003, seed=13)
    hp = pairs.intersect_pairs(sc, o, d, tmin, tmax)
    ht = tc.intersect_traverse(sc, o, d, tmin, tmax)
    assert torch.equal(hp.valid, ht.valid)
    v = ht.valid
    plane, mt = pairs.rounding_bounds(sc, o[v], d[v], ht.prim[v], ht.t[v])
    tol = 1e-6 * ht.t[v].abs() + 4.0 * (plane + mt).float()
    assert bool(((hp.t[v] - ht.t[v]).abs() <= tol).all())
    assert int((hp.prim[v] != ht.prim[v]).sum()) <= 10
    assert torch.equal(pairs.occluded_pairs(sc, o, d, tocc),
                       tc.occluded_traverse(sc, o, d, tocc))


@pytest.mark.cuda
def test_pairs_render_goes_through_pair_kernels(monkeypatch):
    """With TPUTRACER_PAIRS=1 a mesh render on the card launches the
    expand, pair-test and traversal kernels 2*bounces+1 times each per
    chunk and gives the default route's image at the golden tolerances."""
    need_card()
    sc = mesh_scene(subdiv=4, device="cuda")
    cfg = RenderConfig(width=32, height=32, spp=4, max_bounces=8,
                       rr_start=3)
    img_d, _ = render_pt(sc, cfg)
    monkeypatch.setenv("TPUTRACER_PAIRS", "1")
    route = ("expand_kernel", "pairtest_kernel", B2, B1)
    before = [LAUNCHES[k] for k in route]
    img_p, _ = render_pt(sc, cfg)
    torch.cuda.synchronize()
    n = 2 * cfg.max_bounces + 1
    assert [LAUNCHES[k] for k in route] == [before[0] + n, before[1] + n,
                                            before[2] + n, before[3]]
    img_p, img_d = img_p.cpu().numpy(), img_d.cpu().numpy()
    rel = np.abs(img_p - img_d) / (1.0 + np.abs(img_d))
    assert float(rel.mean()) < 5e-4 and float((rel > 5e-3).mean()) < 0.01
    assert float(img_p.mean()) > 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("option", ["sort_rays", "remat"])
def test_cuda_render_sort_rays_and_remat_keep_the_bits(option):
    """On the card too, sort_rays (the wavefront permuted after each
    bounce on a clustered mesh) and remat render the bits of the render
    without them."""
    need_card()
    sc = mesh_scene(subdiv=4, device="cuda")
    cfg = RenderConfig(width=32, height=32, spp=4, max_bounces=8,
                       rr_start=3)
    img, _ = render_pt(sc, cfg)
    img_opt, _ = render_pt(sc, cfg.with_(**{option: True}))
    assert torch.equal(img, img_opt) and float(img.mean()) > 0.1


def bdpt_through(sc, cfg, isect=None, occl=None):
    """trace_bdpt_rows of a whole BDPT render of ``sc`` at ``cfg`` through
    the given hooks (None: accel.intersect / accel.occluded, the kernels
    on the card): (L_own, splat, stats)."""
    uids = torch.arange(cfg.width * cfg.height * cfg.spp, dtype=torch.int64,
                        device=sc.device)
    return trace_bdpt_rows(sc, uids, cfg, intersect_fn=isect,
                           occluded_fn=occl)


@pytest.mark.cuda
def test_cuda_bdpt_goes_through_kernel():
    """BDPT on the caustics scene launches the intersection kernel 25 times
    a chunk at 4 bounces (10 walk steps, 10 connections, 5 t=1 calls) and
    gives the plain version's per-path radiance bit for bit; the splat,
    which index_add_ sums in no fixed order on the card, at float
    tolerance.  No step of the kernel's render waits on the card."""
    need_card()
    sc = cornell_box("caustic", device="cuda")
    cfg = BdptConfig(width=64, height=64, spp=4, max_bounces=4,
                     chunk_size=1 << 13)
    launches, walks = LAUNCHES[B1], LAUNCHES[B2]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")   # nothing may wait on the card
    try:
        L_k, sp_k, st_k = bdpt_through(sc, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert LAUNCHES[B1] == launches + 2 * 25 and LAUNCHES[B2] == walks
    L_p, sp_p, st_p = bdpt_through(sc, cfg, intersect_plain, occluded_plain)
    assert torch.equal(L_k, L_p)
    torch.testing.assert_close(sp_k, sp_p, rtol=1e-5, atol=1e-7)
    assert all(torch.equal(st_k[k], st_p[k]) for k in st_p)
    assert float(L_k.mean()) > 0.0 and float(sp_k.sum()) > 0.0


@pytest.mark.cuda
def test_cuda_mesh_bdpt_goes_through_traversal_kernel():
    """BDPT on a clustered mesh launches the traversal kernel 25 times a
    chunk, the intersection kernel never, and gives the plain walk's
    per-path radiance bit for bit."""
    need_card()
    sc = mesh_scene(subdiv=4, device="cuda")
    cfg = BdptConfig(width=32, height=32, spp=4, max_bounces=4)
    launches, fused = LAUNCHES[B2], LAUNCHES[B1]
    L_k, sp_k, _ = bdpt_through(sc, cfg)
    torch.cuda.synchronize()
    assert LAUNCHES[B2] == launches + 25 and LAUNCHES[B1] == fused
    L_p, sp_p, _ = bdpt_through(sc, cfg, intersect_clustered,
                                occluded_clustered)
    assert torch.equal(L_k, L_p)
    torch.testing.assert_close(sp_k, sp_p, rtol=1e-5, atol=1e-7)
    assert float(L_k.mean()) > 0.0


@pytest.mark.cuda
def test_cuda_progressive_bdpt_matches_single_shot(tmp_path):
    """Progressive BDPT on the card, killed after a pass and resumed from
    its checkpoint, against the single-shot render (float tolerance: the
    splat sums in no fixed order)."""
    need_card()
    sc = cornell_box("caustic", device="cuda")
    cfg = BdptConfig(width=32, height=32, spp=4, max_bounces=4)
    ck = str(tmp_path / "film.npz")

    def die(done, _):
        raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        render_bdpt_progressive(sc, cfg, spp_per_pass=2, checkpoint_path=ck,
                                callback=die)
    img, done = render_bdpt_progressive(sc, cfg, spp_per_pass=2,
                                        checkpoint_path=ck)
    ref, _ = render_bdpt(sc, cfg)
    assert done == cfg.spp
    np.testing.assert_allclose(img, ref.cpu().numpy(), rtol=1e-4, atol=1e-7)


def fit_problem(size=64):
    """Config 5's problem at ``size``^2 on the card: (scene, cfg, target,
    start tables)."""
    from chip_smoke import FIT_CFG, fit_start

    sc = cornell_box("boxes", device="cuda")
    cfg = RenderConfig(**dict(FIT_CFG, width=size, height=size))
    with torch.no_grad():
        target, _ = render_pt(sc, cfg)
    return sc, cfg, target, fit_start(sc)


@pytest.mark.cuda
def test_cuda_grad_kernel_hooks_match_plain():
    """Under autograd the kernel's render gives the plain hooks' loss and
    gradients bit for bit: the forward pass is bit-equal, and the lookups'
    backward (a sort, then an accumulate in sorted order) repeats its bits
    on the card."""
    from chip_smoke import hooked_grads

    need_card()
    sc, cfg, target, start = fit_problem()
    loss_k, g_k = hooked_grads(sc, start, target, cfg)
    loss_p, g_p = hooked_grads(sc, start, target, cfg, intersect_plain,
                               occluded_plain)
    assert torch.equal(loss_k, loss_p)
    for k in g_p:
        assert torch.equal(g_k[k], g_p[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_cuda_grad_render_launches(remat):
    """grad_render at config 5's widths launches the intersection kernel 7
    times (4 closest-hit and 3 shadow calls), and 14 with remat, whose
    backward pass recomputes every bounce; the traversal kernel never."""
    from tputracer_torch.api import grad_render

    need_card()
    sc, cfg, target, start = fit_problem()
    launches, walks = LAUNCHES[B1], LAUNCHES[B2]
    loss, grads = grad_render(sc, start, target, cfg, remat=remat)
    torch.cuda.synchronize()
    assert LAUNCHES[B1] - launches == (14 if remat else 7)
    assert LAUNCHES[B2] == walks
    assert loss.is_cuda and all(g.is_cuda for g in grads.values())
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())


@pytest.mark.cuda
def test_cuda_fit_resume_matches_uninterrupted(tmp_path):
    """A fit on the card stopped at step 3 and resumed from its checkpoint
    equals the uninterrupted fit bit for bit: the later losses and the
    parameters."""
    from tputracer_torch.fit import fit

    need_card()
    sc, cfg, target, start = fit_problem(32)
    kw = dict(cfg=cfg, init=start, learning_rate=1e-2, log_every=0,
              checkpoint_every=3, steps_per_dispatch=3)
    _, p_full, h_full = fit(sc, target, steps=6,
                            checkpoint_path=str(tmp_path / "full.npz"), **kw)
    ck = str(tmp_path / "stop.npz")
    fit(sc, target, steps=3, checkpoint_path=ck, **kw)
    _, p_res, h_res = fit(sc, target, steps=6, checkpoint_path=ck, **kw)
    assert [h["step"] for h in h_res] == [3, 4, 5]
    assert [h["loss"] for h in h_res] == [h["loss"] for h in h_full[3:]]
    for k in p_full:
        assert p_res[k].is_cuda and torch.equal(p_res[k], p_full[k]), k


@functools.lru_cache(maxsize=None)
def dist_ranks(out_dir):
    """Two gloo ranks sharing the card (tests/torch_dist_worker.py, mode
    "card"), toward the single card's config-5 target at 32x32; their
    saved results, run once per test process."""
    import os

    import torch_dist_worker as W
    from chip_smoke import FIT_CFG, fit_start

    need_card()
    sc = cornell_box("boxes", device="cuda")
    cfg = RenderConfig(**dict(FIT_CFG, width=32, height=32))
    with torch.no_grad():
        target, _ = render_pt(sc, cfg)
    os.makedirs(out_dir, exist_ok=True)
    tgt = os.path.join(out_dir, "target.npy")
    np.save(tgt, target.cpu().numpy())
    for rc, _, err in W.run_world("card", 2, out_dir, timeout=300,
                                  target=tgt):
        assert rc == 0, err[-3000:]
    return [W.load(out_dir, r) for r in range(2)], target, fit_start(sc), cfg


@pytest.fixture
def dist_world(tmp_path_factory):
    need_card()
    return dist_ranks(str(tmp_path_factory.getbasetemp() / "dist_card"))


@pytest.mark.cuda
def test_cuda_dist_kernel_on_ring_hops_matches_plain(dist_world):
    """The traversal kernel on each second hop of a tiled config-3 chunk
    (the other rank's rays, with the carry of their first hop, in this
    rank's clusters), closest and any hit, against the clustered walk on
    the same inputs: bit for bit."""
    ranks, _, _, _ = dist_world
    for z in ranks:
        assert z["hop_bitwise"].all()
        assert z["hop_carried"].sum() > 0


@pytest.mark.cuda
def test_cuda_dist_tiled_matches_replicated(dist_world):
    """render_tiled of config 3 at 64x64 on two ranks sharing the card
    against the single card's render (rtol 2e-5, atol 2e-6), with equal
    ray counts."""
    ranks, _, _, _ = dist_world
    from chip_smoke import MESH_CFG

    cfg = RenderConfig(**dict(MESH_CFG, width=64, height=64))
    ref, stats = render_pt(mesh_scene(subdiv=6, device="cuda"), cfg)
    for z in ranks:
        np.testing.assert_allclose(z["tiled_img"], ref.cpu().numpy(),
                                   rtol=2e-5, atol=2e-6)
        for k in ("rays_closest", "rays_shadow"):
            np.testing.assert_array_equal(z[f"tiled_{k}"],
                                          stats[k].cpu().numpy())


@pytest.mark.cuda
def test_cuda_dist_fit_step_matches_grad_render(dist_world):
    """fit_step_sharded on two ranks sharing the card against the single
    card's grad_render: the loss at rtol 1e-6, the gradients within 1e-5
    of each table's largest entry."""
    from tputracer_torch.api import grad_render

    ranks, target, start, cfg = dist_world
    loss, grads = grad_render(cornell_box("boxes", device="cuda"), start,
                              target, cfg)
    for z in ranks:
        np.testing.assert_allclose(z["fit_loss"], float(loss), rtol=1e-6)
        for k, g in grads.items():
            g = g.cpu().numpy()
            np.testing.assert_allclose(z[f"fit_grad_{k}"], g, rtol=0,
                                       atol=1e-5 * np.abs(g).max())


@pytest.mark.cuda
def test_cuda_dist_nccl_world_of_one_is_api_render(tmp_path):
    """A world of one on NCCL: render_sharded has api.render's bits."""
    from tputracer_torch.api import render
    from tputracer_torch.dist import launch, make_mesh, render_sharded

    need_card()
    sc = cornell_box("boxes", device="cuda")
    cfg = RenderConfig(width=64, height=64, spp=4, max_bounces=4)
    launch.initialize(f"file://{tmp_path}/world", 1, 0, backend="nccl")
    try:
        img, stats = render_sharded(sc, cfg, make_mesh())
    finally:
        launch.shutdown()
    ref, ref_stats = render(sc, cfg)
    assert torch.equal(img, ref)
    for k in ref_stats:
        assert torch.equal(stats[k], ref_stats[k]), k


@pytest.mark.cuda
def test_cuda_dist_nccl_refuses_two_ranks_on_one_card(tmp_path):
    """Two NCCL ranks on one card: each rank's initialize raises, naming
    gloo, before NCCL communicates."""
    import torch_dist_worker as W

    need_card()
    for rc, _, err in W.run_world("join", 2, str(tmp_path), timeout=120,
                                  backend="nccl"):
        assert rc != 0
        assert "share one" in err and "gloo" in err, err[-3000:]


# ---- the compiled entry points: CUDA graphs (graphs.py) ---------------------

GRAPH_CASES = {
    "boxes": ("boxes", RenderConfig(width=64, height=64, spp=4,
                                    max_bounces=4, chunk_size=1 << 13)),
    "spheres": ("spheres", RenderConfig(width=32, height=32, spp=8,
                                        max_bounces=6, rr_start=3,
                                        chunk_size=1 << 12)),
    "mesh": ("mesh", RenderConfig(width=32, height=32, spp=4, max_bounces=8,
                                  rr_start=3)),
    "mesh pairs": ("mesh", RenderConfig(width=32, height=32, spp=4,
                                        max_bounces=8, rr_start=3)),
}


def graph_scene(name):
    if name == "mesh":
        return mesh_scene(subdiv=4, device="cuda")
    return cornell_box(name, device="cuda")


def counted_call(fn):
    """(fn()'s result, the launches it added to each kernel's counter)."""
    from chip_smoke import launch_counts

    before = launch_counts()
    out = fn()
    torch.cuda.synchronize()
    after = launch_counts()
    return out, {k: after[k] - before[k] for k in after}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_graph_render_matches_eager(case, monkeypatch):
    """api.render runs its first call eagerly, captures one graph on its
    second and replays it after: every call gives the eager render's
    image and ray counts bit for bit (on the pair route, replays rely on
    the fold keys being all ones again), the graph's kernel nodes are one
    render's launches, and the launch counters after a call read one
    render's launches, whether it ran eagerly, captured or replayed."""
    from chip_smoke import by_counter
    from tputracer_torch import graphs
    from tputracer_torch.api import render

    need_card()
    graphs.clear()
    if case == "mesh pairs":
        monkeypatch.setenv("TPUTRACER_PAIRS", "1")
    scene, cfg = GRAPH_CASES[case]
    sc = graph_scene(scene)
    captures = graphs.CAPTURES
    (img_e, st_e), want = counted_call(lambda: render_pt(sc, cfg))
    assert sum(want.values()) > 0
    for call in range(4):
        (img, st), launches = counted_call(lambda: render(sc, cfg))
        assert launches == want, (call, launches, want)
        assert graphs.CAPTURES == captures + min(call, 1)
        assert torch.equal(img, img_e), call
        assert all(torch.equal(st[k], st_e[k]) for k in st_e), call
    assert graphs.graphs()[0].replays == 3
    assert by_counter(graphs.graphs()[0].census) == want
    assert float(img.mean()) > 0.1
    graphs.clear()


@pytest.mark.cuda
def test_graph_bdpt_matches_eager():
    """render_bdpt through its graph: the eager ray counts bit for bit,
    the image within the splat's float tolerance (index_add_ adds in no
    fixed order); trace_bdpt_rows through graphs.call: the per-path
    radiance bit for bit."""
    from tputracer_torch import graphs
    from tputracer_torch.integrators import bdpt

    need_card()
    graphs.clear()
    sc = cornell_box("caustic", device="cuda")
    cfg = BdptConfig(width=64, height=64, spp=4, max_bounces=4,
                     chunk_size=1 << 13)
    (img_e, st_e), want = counted_call(lambda: bdpt.render_bdpt(sc, cfg))
    assert want["fused_intersect"] == 2 * 25
    for _ in range(3):   # eager, the capture, a replay
        (img, st), launches = counted_call(lambda: render_bdpt(sc, cfg))
        assert launches == want
        torch.testing.assert_close(img, img_e, rtol=1e-5, atol=1e-7)
        for k in ("rays_closest", "rays_shadow"):
            assert torch.equal(st[k], st_e[k]), k
    L_e, sp_e, _ = bdpt_through(sc, cfg)
    for _ in range(3):
        L_g, sp_g, _ = graphs.call("bdpt_rows",
                                   lambda s: bdpt_through(s, cfg), sc, cfg)
        assert torch.equal(L_g, L_e)
        torch.testing.assert_close(sp_g, sp_e, rtol=1e-5, atol=1e-7)
    graphs.clear()


@pytest.mark.cuda
def test_graph_sees_edits_without_capturing_again():
    """A material edited in place and then replaced by a new tensor of the
    same shape replay the same graph and give the eager render's bits of
    the edited scene; a scene of other shapes captures a new graph (on
    its second call); with a table that requires grad, the call runs
    eagerly and keeps its grad_fn."""
    import dataclasses

    from tputracer_torch import graphs
    from tputracer_torch.api import render

    need_card()
    graphs.clear()
    base = cornell_box("boxes", device="cuda")
    cfg = RenderConfig(width=32, height=32, spp=4, max_bounces=4)
    sc = dataclasses.replace(base, mat_albedo=base.mat_albedo.clone())
    render(sc, cfg)   # eager
    render(sc, cfg)   # the capture
    captures = graphs.CAPTURES
    sc.mat_albedo.mul_(0.5)
    img, _ = render(sc, cfg)
    assert torch.equal(img, render_pt(sc, cfg)[0])
    sc2 = dataclasses.replace(sc, mat_albedo=base.mat_albedo * 0.25)
    img2, _ = render(sc2, cfg)
    assert torch.equal(img2, render_pt(sc2, cfg)[0])
    assert not torch.equal(img, img2)
    assert graphs.CAPTURES == captures
    spheres = cornell_box("spheres", device="cuda")
    render(spheres, cfg)
    assert graphs.CAPTURES == captures
    render(spheres, cfg)
    assert graphs.CAPTURES == captures + 1
    sc3 = dataclasses.replace(
        base, mat_albedo=base.mat_albedo.clone().requires_grad_())
    img3, _ = render(sc3, cfg)
    assert img3.grad_fn is not None and graphs.CAPTURES == captures + 1
    with torch.no_grad():
        assert torch.equal(img3, render_pt(sc3, cfg)[0])
    graphs.clear()


@pytest.mark.cuda
def test_graph_replays_from_other_streams_match_eager():
    """One graph called from two user streams in turns, with nothing
    between the calls (the mesh, whose B2 ray counter the replays share):
    every call gives the eager bits, as the replays run one at a time on
    the capture stream."""
    from tputracer_torch import graphs
    from tputracer_torch.api import render

    need_card()
    graphs.clear()
    _, cfg = GRAPH_CASES["mesh"]
    sc = graph_scene("mesh")
    img_e, st_e = render_pt(sc, cfg)
    streams = [torch.cuda.Stream() for _ in range(2)]
    outs = []
    for s in streams * 3:
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            outs.append(render(sc, cfg))
    torch.cuda.synchronize()
    for img, st in outs:
        assert torch.equal(img, img_e)
        assert all(torch.equal(st[k], st_e[k]) for k in st_e)
    assert graphs.graphs()[0].replays == 5
    graphs.clear()


@pytest.mark.cuda
def test_graph_progressive_matches_eager_passes():
    """render_progressive replays one graph for every full pass and a
    second for the shorter last one (captured on its key's second call,
    the next render's), with the eager passes' film bit for bit;
    render_bdpt_progressive at the splat's float tolerance."""
    from tputracer_torch import api, graphs

    need_card()
    graphs.clear()
    sc = cornell_box("boxes", device="cuda")
    cfg = RenderConfig(width=32, height=32, spp=10, max_bounces=4)
    captures = graphs.CAPTURES
    ref, _ = api._progressive_loop(
        sc, cfg, lambda off, step: api._pt_pass(sc, cfg, off, step), 4, None,
        True, None)
    for n in (1, 2):   # passes of 4, 4, 2: the last one's key is new
        img, done = api.render_progressive(sc, cfg, spp_per_pass=4)
        assert done == 10 and graphs.CAPTURES == captures + n
        assert np.array_equal(img, ref)
    caustic = cornell_box("caustic", device="cuda")
    bcfg = BdptConfig(width=32, height=32, spp=4, max_bounces=4)
    img_b, _ = api.render_bdpt_progressive(caustic, bcfg, spp_per_pass=2)
    ref_b, _ = api._progressive_loop(
        caustic, bcfg,
        lambda off, step: api._bdpt_pass(caustic, bcfg, off, step), 2, None,
        True, None)
    np.testing.assert_allclose(img_b, ref_b, rtol=1e-5, atol=1e-7)
    assert graphs.CAPTURES == captures + 3
    graphs.clear()


# ---- the graphs' spans and replay timing (tputracer_torch.trace) -----------

@pytest.mark.cuda
def test_graph_copy_in_counts_the_static_inputs_bytes():
    """Each replay's ``graphs.copy_in`` record counts the tensors copied
    (every scene and camera tensor, then the inputs) and their bytes: the
    sum of their nbytes."""
    from tputracer_torch import api, graphs, trace

    need_card()
    graphs.clear()
    trace.reset()
    sc = cornell_box("boxes", device="cuda")
    cfg = RenderConfig(width=32, height=32, spp=8, max_bounces=4)
    off = torch.zeros((1,), dtype=torch.int64, device="cuda")
    for _ in range(3):   # eager, the capture and its replay, a replay
        api._progressive_pass_jit(sc, off, 4, cfg)
    torch.cuda.synchronize()
    tensors = graphs.scene_tensors(sc) + [off]
    recs = trace.records("graphs.copy_in")
    assert len(recs) == 2
    for rec in recs:
        assert rec.counts == {"tensors": len(tensors),
                              "bytes": sum(t.nbytes for t in tensors)}
    assert graphs.graphs()[0].in_bytes == sum(t.nbytes for t in tensors)
    graphs.clear()


@pytest.mark.cuda
def test_graph_replays_are_timed_on_the_device():
    """Each replay's ``graphs.launch`` record gets its device times from
    the graph's event nodes: the wait before the first node and the
    replay, both >= 0, the replay no longer than the call's wall time."""
    import time

    from tputracer_torch import graphs, trace
    from tputracer_torch.api import render

    need_card()
    graphs.clear()
    trace.reset()
    scene, cfg = GRAPH_CASES["boxes"]
    sc = graph_scene(scene)
    render(sc, cfg)          # eager
    render(sc, cfg)          # the capture, then its replay
    torch.cuda.synchronize()
    walls = []
    for _ in range(4):
        t0 = time.perf_counter()
        render(sc, cfg)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    recs = trace.records("graphs.launch")
    assert len(recs) == 5
    for rec in recs:
        assert rec.device is not None and "untimed" not in rec.counts
        assert rec.device["wait_ms"] >= 0 and rec.device["replay_ms"] > 0
    for rec, wall in zip(recs[1:], walls):
        assert rec.device["replay_ms"] <= wall
    calls = trace.records("graphs.call")
    assert len(calls) == 6
    assert all(r.root == c.id for r, c in zip(recs, calls[1:]))
    graphs.clear()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["boxes", "mesh"])
def test_graph_event_nodes_leave_the_kernel_census(case):
    """The graph's two event-record nodes are no kernels: its kernel
    nodes are what the eager render launches (the launch counters) and
    what a traced replay runs, kernel for kernel."""
    from chip_smoke import by_counter
    from tputracer_torch import graphs
    from tputracer_torch.api import render

    need_card()
    graphs.clear()
    scene, cfg = GRAPH_CASES[case]
    sc = graph_scene(scene)
    _, want = counted_call(lambda: render_pt(sc, cfg))
    render(sc, cfg)
    render(sc, cfg)
    census = graphs.graphs()[0].census
    assert census["event_nodes"] == 2
    assert by_counter(census) == want
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    counts = []
    for _ in range(3):   # CUPTI can drop a record
        with torch.profiler.profile(activities=acts) as prof:
            render(sc, cfg)
            torch.cuda.synchronize()
        host = {e.name for e in prof.events()
                if e.device_type != torch.autograd.DeviceType.CUDA}
        counts.append(sum(
            1 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.name not in host
            and not e.name.startswith(("Memcpy", "Memset"))))
        if counts[-1] == census["kernel_nodes"]:
            break
    assert census["kernel_nodes"] in counts, counts
    graphs.clear()


# ---- the sampler kernel (csrc/rng.cu) ---------------------------------------

def sampler_uids(n, seed):
    """n int64 uids: random over the whole int64 range (negative ones and
    ones >= 2^32 among them), then small ones and the edges of 2^31 and
    2^32, as far as n allows."""
    r = np.random.default_rng(seed)
    edges = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1, 2**32, 2**32 + 7,
                      -1, -(2**31), -(2**32) - 3, 2**63 - 1, -(2**63)],
                     np.int64)
    uid = np.concatenate([edges,
                          r.integers(-(2**63), 2**63 - 1, n, np.int64)])
    return torch.from_numpy(uid[:n]).cuda()


SAMPLER_DRAWS = [(0, 0), (3 * 8 + 1, 7), (2**31 + 5, 2**32 - 1),
                 (2**32 - 1, 2**31), (123_456_789, 4_000_000_000)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 1023, 1 << 16, (1 << 20) + 5])
def test_uniform3_kernel_matches_plain(n):
    """The kernel's three streams are uniform3_plain's bit for bit, for
    uids anywhere in int64 and salts and seeds at and above 2^31; one
    launch a call."""
    from tputracer_torch import rng

    need_card()
    uid = sampler_uids(n, seed=n)
    for salt, seed in SAMPLER_DRAWS:
        launches = LAUNCHES["uniform3_kernel"]
        got = rng.uniform3_cuda(uid, salt, seed)
        want = rng.uniform3_plain(uid, salt, seed)
        torch.cuda.synchronize()
        assert LAUNCHES["uniform3_kernel"] == launches + 1
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and g.shape == (n,)
            assert g.is_contiguous()
            assert torch.equal(g, w), (n, salt, seed)


@pytest.mark.cuda
def test_uniform3_kernel_on_slices_and_permutations():
    """uids taken as slices (at offsets that leave them 16-byte aligned
    and not) and permuted as sort_rays permutes them: the kernel's
    streams are the plain version's, and the same draws of the same
    uids wherever they sit."""
    from tputracer_torch import rng

    need_card()
    base = sampler_uids(70_001, seed=3)
    salt, seed = 2**31 + 11, 2**32 - 3
    full = rng.uniform3_cuda(base, salt, seed)
    for lo, hi in ((0, 65_536), (1, 40_001), (2, 70_001), (3, 6), (5, 5)):
        got = rng.uniform3_cuda(base[lo:hi], salt, seed)
        for g, w, f in zip(got, rng.uniform3_plain(base[lo:hi], salt, seed),
                           full):
            assert torch.equal(g, w), (lo, hi)
            assert torch.equal(g, f[lo:hi]), (lo, hi)
    keys = torch.from_numpy(
        np.random.default_rng(4).integers(0, 1 << 20, 70_001)).cuda()
    perm = torch.argsort(keys, stable=True)
    for g, w, f in zip(rng.uniform3_cuda(base[perm], salt, seed),
                       rng.uniform3_plain(base[perm], salt, seed), full):
        assert torch.equal(g, w)
        assert torch.equal(g, f[perm])


@pytest.mark.cuda
def test_uniform3_routes_cuda_uids_to_the_kernel():
    """uniform3 on a CUDA uid launches the kernel once (the span counts
    kernel 1); the wrapper refuses what the kernel does not take."""
    from tputracer_torch import rng, trace

    need_card()
    trace.reset()
    uid = sampler_uids(4_099, seed=5)
    launches = LAUNCHES["uniform3_kernel"]
    got = rng.uniform3(uid, 17, 2**31 + 1)
    assert LAUNCHES["uniform3_kernel"] == launches + 1
    (rec,) = trace.records("rng.uniform3")
    assert rec.counts == {"kernel": 1}
    for g, w in zip(got, rng.uniform3_plain(uid, 17, 2**31 + 1)):
        assert torch.equal(g, w)
    for bad in (uid.to(torch.int32), uid.reshape(1, -1), uid[::2],
                uid.cpu()):
        with pytest.raises(ValueError, match="uniform3_cuda"):
            rng.uniform3_cuda(bad, 0, 0)
    assert LAUNCHES["uniform3_kernel"] == launches + 1


# config 1 and config 3 (BASELINE configs[0], [2]) and their draws a
# render: a chunk draws for the camera, for the light and the BSDF at every
# bounce but the last, and for Russian roulette from rr_start on
SAMPLER_RENDERS = {
    "config 1": ("boxes", RenderConfig(width=512, height=512, spp=16,
                                       max_bounces=4), 4 * (1 + 8 + 1)),
    "config 3": ("mesh", RenderConfig(width=256, height=256, spp=4,
                                      max_bounces=8, rr_start=3,
                                      chunk_size=1 << 16), 4 * (1 + 16 + 5)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SAMPLER_RENDERS))
def test_graph_renders_through_the_sampler_kernel_match_torch_sampler(
        case, monkeypatch):
    """A graphed render (its eager first call, the capture, a replay)
    launches the sampler kernel once a draw, and the graph holds those
    launches; its image and ray counts are, bit for bit, those of the
    same graphed render with uniform3 forced onto the torch route."""
    from tputracer_torch import graphs, rng
    from tputracer_torch.api import render

    need_card()
    name, cfg, draws = SAMPLER_RENDERS[case]
    sc = (mesh_scene(subdiv=6, device="cuda") if name == "mesh"
          else cornell_box(name, device="cuda"))

    def three_calls():
        graphs.clear()
        outs, launches = [], []
        for _ in range(3):   # eager, the capture, a replay
            before = LAUNCHES["uniform3_kernel"]
            outs.append(render(sc, cfg))
            torch.cuda.synchronize()
            launches.append(LAUNCHES["uniform3_kernel"] - before)
        nodes = graphs.graphs()[0].census["uniform3_kernel"]
        graphs.clear()
        return outs, launches, nodes

    kernel, launches, nodes = three_calls()
    assert launches == [draws] * 3 and nodes == draws
    monkeypatch.setattr(rng, "uniform3", rng.uniform3_plain)
    plain, launches, nodes = three_calls()
    assert launches == [0] * 3 and nodes == 0
    for (img_k, st_k), (img_p, st_p) in zip(kernel, plain):
        assert torch.equal(img_k, img_p)
        assert all(torch.equal(st_k[k], st_p[k]) for k in st_p)
    assert float(kernel[-1][0].mean()) > 0.1


def connect_vertices(name, lanes, cfg):
    """The eye and light subpaths of the first ``lanes`` paths of a BDPT
    render of scene ``name`` (a Cornell variant or "mesh", subdiv 4) at
    ``cfg`` on the card: (scene, ys, zs)."""
    from tputracer_torch.integrators.bdpt import eye_subpaths, light_subpaths

    sc = (mesh_scene(subdiv=4, device="cuda") if name == "mesh"
          else cornell_box(name, device="cuda"))
    uid = torch.arange(lanes, dtype=torch.int64, device="cuda")
    with torch.no_grad():
        return (sc, light_subpaths(sc, uid, cfg), eye_subpaths(sc, uid, cfg))


# (scene, lanes, max_bounces, mis_power): the caustic box (BASELINE config
# 4) at a chunk of 2^16 and of 2^20 paths; config 2's mirror and glass
# spheres, whose delta vertices suppress strategies; a clustered mesh,
# whose shadow rays go through the traversal kernel between the kernels
CONNECT_CASES = (
    [("caustic", lanes, b, power) for lanes in (1 << 16, 1 << 20)
     for b in (3, 4, 6) for power in (False, True)]
    + [("spheres", 1 << 16, 4, False), ("spheres", 1 << 16, 6, True),
       ("mesh", 1 << 16, 4, False)])


@pytest.mark.cuda
@pytest.mark.parametrize("case", CONNECT_CASES,
                         ids=["-".join(map(str, c)) for c in CONNECT_CASES])
def test_connect_kernels_match_plain(case):
    """The connection kernels (csrc/connect.cu) give
    connection_radiance_plain's radiance and shadow-ray count bit for bit,
    in two launches; nothing in the kernels' route waits on the card."""
    from tputracer_torch.integrators import bdpt

    need_card()
    name, lanes, bounces, power = case
    cfg = BdptConfig(width=1024, height=1024, spp=1, max_bounces=bounces,
                     mis_power=power)
    sc, ys, zs = connect_vertices(name, lanes, cfg)
    got, want = {}, {}
    with torch.no_grad():
        assert bdpt.bdpt_on_card(sc, ys, zs)
        launches, walks = connect_launches(), LAUNCHES[B2]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            L_k = bdpt.connection_radiance(sc, cfg, ys, zs, stats_acc=got)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        L_p = bdpt.connection_radiance_plain(sc, cfg, ys, zs, stats_acc=want)
    torch.cuda.synchronize()
    assert connect_launches() == launches + 2
    n_s = (bounces + 1) * bounces // 2
    assert LAUNCHES[B2] - walks == (2 * n_s if name == "mesh" else 0)
    assert L_k.shape == (lanes, 3) and L_k.is_contiguous()
    assert torch.equal(L_k, L_p)
    assert torch.equal(got["rays_shadow"], want["rays_shadow"])
    assert float(L_p.sum()) > 0.0 and float(want["rays_shadow"]) > 0.0


@pytest.mark.cuda
def test_connect_kernels_refuse_what_they_do_not_take():
    """The wrapper refuses, before any launch, vertices that are not
    contiguous or not of their dtype, and an occlusion result that is not
    an (n,) bool tensor."""
    from tputracer_torch.integrators import bdpt_cuda

    need_card()
    cfg = BdptConfig(width=64, height=64, spp=1, max_bounces=3)
    sc, ys, zs = connect_vertices("caustic", 4096, cfg)
    launches = connect_launches()
    strided = torch.empty((4096, 6), device="cuda")[:, :3]
    for side, field, bad in ((zs, "p", strided),
                             (ys, "beta", ys[1]["beta"].double()),
                             (zs, "mat", zs[2]["mat"].long()),
                             (ys, "valid", ys[0]["valid"][:-1])):
        vert = 1 if side is zs else 0
        kept = side[vert][field]
        side[vert][field] = bad
        try:
            with pytest.raises(ValueError, match="connection_radiance_cuda"):
                bdpt_cuda.connection_radiance_cuda(sc, cfg, ys, zs)
        finally:
            side[vert][field] = kept
    with pytest.raises(ValueError, match="occlusion result 0"):
        bdpt_cuda.connection_radiance_cuda(
            sc, cfg, ys, zs, occl=lambda s, o, d, tmax: (tmax > 0).float())
    assert connect_launches() == launches + 1   # the last call's first kernel


@pytest.mark.cuda
def test_graph_bdpt_connect_kernels_match_eager_plain(monkeypatch):
    """trace_bdpt_rows of config 4's scene through graphs.call (eager
    first call, the capture, a replay) takes the connection kernels, two
    launches a chunk that the graph holds as kernel nodes (and two table
    fills), and gives, bit for bit, the per-path radiance and ray counts
    of the eager render with the connections on the torch route; each
    chunk's bdpt.connect span counts kernel 1, and 0 on that route."""
    from tputracer_torch import graphs, trace
    from tputracer_torch.integrators import bdpt

    need_card()
    graphs.clear()
    sc = cornell_box("caustic", device="cuda")
    cfg = BdptConfig(width=64, height=64, spp=4, max_bounces=4,
                     chunk_size=1 << 13)
    chunks = cfg.width * cfg.height * cfg.spp // cfg.chunk_size
    for _ in range(3):
        trace.reset()
        before = connect_launches()
        L_g, _, st_g = graphs.call("bdpt_rows",
                                   lambda s: bdpt_through(s, cfg), sc, cfg)
        torch.cuda.synchronize()
        assert connect_launches() - before == 2 * chunks
    g = graphs.graphs()[0]
    assert g.census["connect_prepare_kernel"] == chunks
    assert g.census["connect_finish_kernel"] == chunks
    # two table fills a chunk for the connections, two for the splats
    assert g.census["connect_table_kernel"] == 4 * chunks
    with monkeypatch.context() as m:
        m.setattr(bdpt, "connection_radiance", bdpt.connection_radiance_plain)
        trace.reset()
        before = connect_launches()
        L_e, _, st_e = bdpt_through(sc, cfg)
        assert connect_launches() == before
    assert torch.equal(L_g, L_e)
    assert all(torch.equal(st_g[k], st_e[k]) for k in st_e)
    graphs.clear()
    trace.reset()
    bdpt_through(sc, cfg)
    assert [r.counts["kernel"] for r in trace.records("bdpt.connect")] == \
        [1] * chunks


@pytest.mark.cuda
def test_bdpt_gradient_takes_the_torch_route(monkeypatch):
    """A BDPT gradient on the card (albedo and emission requiring grad)
    runs the connections and the splats on the torch route: no connection
    or splat kernel, the kernel count 0 on every bdpt.connect and
    bdpt.splat span, and the gradients of the same call with
    connection_radiance_plain in its place (within the splat's float
    tolerance: index_add_ adds in no fixed order)."""
    from tputracer_torch import api, trace
    from tputracer_torch.integrators import bdpt, bdpt_cuda

    need_card()
    sc = cornell_box("caustic", device="cuda")
    cfg = BdptConfig(width=32, height=32, spp=2, max_bounces=3)
    target = torch.full((32, 32, 3), 0.05, device="cuda")
    params = {k: getattr(sc, k).clone().requires_grad_()
              for k in ("mat_albedo", "mat_emission")}

    def grads():
        return api._loss_and_grads(bdpt.render_bdpt, sc, params, target, cfg)

    def refuse(*args, **kwargs):
        raise AssertionError("the kernels' route under a gradient")

    trace.reset()
    launches = connect_launches(), splat_launches()
    with monkeypatch.context() as m:
        m.setattr(bdpt_cuda, "connection_radiance_cuda", refuse)
        m.setattr(bdpt_cuda, "t1_splats_cuda", refuse)
        loss, g = grads()
    assert (connect_launches(), splat_launches()) == launches
    assert [r.counts["kernel"] for r in trace.records("bdpt.connect")] == [0]
    assert [r.counts["kernel"] for r in trace.records("bdpt.splat")] == [0]
    with monkeypatch.context() as m:
        m.setattr(bdpt, "connection_radiance", bdpt.connection_radiance_plain)
        loss_p, g_p = grads()
    torch.testing.assert_close(loss, loss_p, rtol=1e-5, atol=0.0)
    for k in g_p:
        assert bool(torch.isfinite(g[k]).all()) and float(g[k].abs().sum()) > 0
        torch.testing.assert_close(g[k], g_p[k], rtol=1e-4, atol=1e-7)


# (scene, lanes, max_bounces, mis_power): the caustic box at a chunk of
# 2^16 and of 2^20 paths; config 2's spheres, whose delta vertices splat
# nothing; a clustered mesh, whose camera rays go through the traversal
# kernel between the kernels
SPLAT_CASES = (
    [("caustic", lanes, b, power) for lanes in (1 << 16, 1 << 20)
     for b in (3, 4, 6) for power in (False, True)]
    + [("spheres", 1 << 16, 4, False), ("mesh", 1 << 16, 4, True)])


@pytest.mark.cuda
@pytest.mark.parametrize("case", SPLAT_CASES,
                         ids=["-".join(map(str, c)) for c in SPLAT_CASES])
def test_splat_kernels_match_plain(case):
    """The splat kernels (csrc/connect.cu) give t1_splats_plain's
    shadow-ray count bit for bit, in one launch of each, and its film
    within the bound of two orders of the same nonnegative sums
    (chip_smoke.splat_film_bound): the kernels add with float atomics and
    index_add_ too, each in no fixed order.  Nothing in the kernels'
    route waits on the card."""
    from tputracer_torch.integrators import bdpt

    need_card()
    name, lanes, bounces, power = case
    cfg = BdptConfig(width=1024, height=1024, spp=1, max_bounces=bounces,
                     mis_power=power)
    sc, ys, zs = connect_vertices(name, lanes, cfg)
    got, want = {}, {}
    with torch.no_grad():
        assert bdpt.bdpt_on_card(sc, ys, zs)
        names = ("splat_prepare_kernel", "splat_finish_kernel", B2)
        before = [LAUNCHES[k] for k in names]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            film_k = bdpt.t1_splats(sc, cfg, ys, zs, stats_acc=got)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        launches = [LAUNCHES[k] - b for k, b in zip(names, before)]
        with splat_adds() as adds:
            film_p = bdpt.t1_splats_plain(sc, cfg, ys, zs, stats_acc=want)
    torch.cuda.synchronize()
    # one traversal launch a strategy on the mesh, none on the boxes
    assert launches == [1, 1, bounces + 1 if name == "mesh" else 0]
    assert film_k.shape == (1024 * 1024, 3) and film_k.is_contiguous()
    assert torch.equal(got["rays_shadow"], want["rays_shadow"])
    assert bool(((film_k - film_p).abs()
                 <= splat_film_bound(adds, film_p)).all())
    assert float(film_p.sum()) > 0.0 and float(want["rays_shadow"]) > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("power", [False, True], ids=["balance", "power"])
@pytest.mark.parametrize("name", ["caustic", "mesh"])
def test_splat_kernels_on_distinct_pixels_match_plain_bit_for_bit(name,
                                                                  power):
    """On a chunk of 128 paths whose splats land on distinct pixels of a
    4096^2 film (the plain route's pixel ids asserted unique first; the
    light's own image is small, so more paths or a smaller film share
    pixels), the kernels' film is t1_splats_plain's bit for bit: each
    splat's contribution (c times its MIS weight) and pixel are the torch
    version's."""
    from tputracer_torch.integrators import bdpt

    need_card()
    cfg = BdptConfig(width=4096, height=4096, spp=1, max_bounces=4,
                     mis_power=power)
    sc, ys, zs = connect_vertices(name, 128, cfg)
    with torch.no_grad():
        with splat_adds() as adds:
            film_p = bdpt.t1_splats_plain(sc, cfg, ys, zs)
        film_k = bdpt.t1_splats(sc, cfg, ys, zs)
    ids = torch.cat([i for i, _ in adds])
    ids = ids[ids < 4096 * 4096]
    assert ids.numel() > 50 and ids.unique().numel() == ids.numel()
    assert torch.equal(film_k, film_p)


@pytest.mark.cuda
def test_splat_kernels_refuse_what_they_do_not_take():
    """The wrapper refuses, before any launch, vertices that are not
    contiguous or not of their dtype, a camera tensor on another device,
    and an occlusion result that is not an (n,) bool tensor."""
    import dataclasses

    from tputracer_torch.integrators import bdpt_cuda

    need_card()
    cfg = BdptConfig(width=64, height=64, spp=1, max_bounces=3)
    sc, ys, zs = connect_vertices("caustic", 4096, cfg)
    launches = splat_launches()
    strided = torch.empty((4096, 6), device="cuda")[:, :3]
    for vert, field, bad in ((1, "p", strided),
                             (0, "beta", ys[0]["beta"].double()),
                             (2, "mat", ys[2]["mat"].long()),
                             (0, "valid", ys[0]["valid"][:-1])):
        kept = ys[vert][field]
        ys[vert][field] = bad
        try:
            with pytest.raises(ValueError, match="t1_splats_cuda"):
                bdpt_cuda.t1_splats_cuda(sc, cfg, ys, zs)
        finally:
            ys[vert][field] = kept
    cpu_cam = dataclasses.replace(sc, camera=sc.camera.to("cpu"))
    with pytest.raises(ValueError, match="t1_splats_cuda: want camera o"):
        bdpt_cuda.t1_splats_cuda(cpu_cam, cfg, ys, zs)
    with pytest.raises(ValueError, match="occlusion result 0"):
        bdpt_cuda.t1_splats_cuda(
            sc, cfg, ys, zs, occl=lambda s, o, d, tmax: (tmax > 0).float())
    assert splat_launches() == launches + 1   # the last call's first kernel


@pytest.mark.cuda
@pytest.mark.parametrize("power", [False, True], ids=["balance", "power"])
def test_graph_bdpt_splat_kernels_match_eager_plain(power, monkeypatch):
    """trace_bdpt_rows of config 4's scene through graphs.call (eager
    first call, the capture, a replay) takes the splat kernels, two
    launches a chunk that the graph holds as kernel nodes, and gives the
    ray counts of the eager render with the splats on the torch route bit
    for bit, and its splat film within the bound of the sums' order; each
    chunk's bdpt.splat span counts kernel 1, and 0 on that route."""
    from tputracer_torch import graphs, trace
    from tputracer_torch.integrators import bdpt

    need_card()
    graphs.clear()
    sc = cornell_box("caustic", device="cuda")
    cfg = BdptConfig(width=64, height=64, spp=4, max_bounces=4,
                     chunk_size=1 << 13, mis_power=power)
    chunks = cfg.width * cfg.height * cfg.spp // cfg.chunk_size
    outs = []
    for _ in range(3):
        before = splat_launches()
        outs.append(graphs.call("bdpt_rows", lambda s: bdpt_through(s, cfg),
                                sc, cfg))
        torch.cuda.synchronize()
        assert splat_launches() - before == 2 * chunks
    g = graphs.graphs()[0]
    assert g.census["splat_prepare_kernel"] == chunks
    assert g.census["splat_finish_kernel"] == chunks
    with monkeypatch.context() as m:
        m.setattr(bdpt, "t1_splats", bdpt.t1_splats_plain)
        before = splat_launches()
        with splat_adds() as adds:
            L_e, sp_e, st_e = bdpt_through(sc, cfg)
        assert splat_launches() == before
    # the chunks' films are summed in chunk order on both routes: each
    # pixel's sum is a sum of the same splats, k of them over all chunks
    bound = splat_film_bound(adds, sp_e)
    for L_g, sp_g, st_g in outs:
        assert torch.equal(L_g, L_e)
        assert all(torch.equal(st_g[k], st_e[k]) for k in st_e)
        assert bool(((sp_g - sp_e).abs() <= bound).all())
    assert float(sp_e.sum()) > 0.0
    graphs.clear()
    trace.reset()
    bdpt_through(sc, cfg)
    assert [r.counts["kernel"] for r in trace.records("bdpt.splat")] == \
        [1] * chunks
