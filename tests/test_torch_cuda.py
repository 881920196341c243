"""The CUDA kernels against their plain versions, on the card.

The fused intersection kernel (csrc/intersect.cu), the cluster-BVH
traversal kernel (csrc/traverse.cu) and the pair route's expand and
pair-test kernels (csrc/pairs.cu) must agree bit for bit with their plain
torch versions, and renders through them with renders through the plain
versions (or, for the pair route, with the default route); BDPT too, its
per-path radiance bit for bit and its splat film at float tolerance;
gradients and fits (config 5) too, bit for bit.  The ray sets are
chip_smoke.py's.

These tests need a CUDA card and skip without one. They import neither
JAX nor the JAX package, so they also run where JAX is not installed; on
the card, run them without the JAX-pinning conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import functools

import numpy as np
import pytest
import torch

from chip_smoke import (bounce_rays, box_soup, dead_rays, face_rays,
                        fallback_input, holey_tables, random_rays, room_rays,
                        run_rays, soup_rays, soup_scene, tie_pairs)
from tputracer_torch.accel import clustered as cl
from tputracer_torch.accel import intersect_cuda as ic
from tputracer_torch.accel import pairs
from tputracer_torch.accel import pairs_cuda as pc
from tputracer_torch.accel import traverse_cuda as tc
from tputracer_torch.accel import (intersect_clustered, intersect_plain,
                                   occluded_clustered, occluded_plain)
from tputracer_torch.api import render_bdpt, render_bdpt_progressive
from tputracer_torch.config import BdptConfig, RenderConfig
from tputracer_torch.integrators.bdpt import trace_bdpt_rows
from tputracer_torch.integrators.pt import render_pt
from tputracer_torch.scene import cornell_box, make_scene, mesh_scene

BIG = 3.0e38


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
    launches = ic.LAUNCHES
    t_k, p_k = ic.fused_intersect_cuda(o, d, tmin, tmax, *args)
    t_p, p_p = ic.fused_intersect_plain(o, d, tmin, tmax, *args)
    torch.cuda.synchronize()
    assert ic.LAUNCHES == launches + 1
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
    launches = ic.LAUNCHES
    t_k, p_k = ic.fused_intersect_cuda(*closest, *args)
    t_p, p_p = ic.fused_intersect_plain(*closest, *args)
    t_a, _ = ic.fused_intersect_cuda(*shadow, *args, any_hit=True)
    t_q, _ = ic.fused_intersect_plain(*shadow, *args)
    torch.cuda.synchronize()
    assert ic.LAUNCHES == launches + 2
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
    launches = ic.LAUNCHES
    img_k, _ = render_pt(sc, cfg)
    torch.cuda.synchronize()
    assert ic.LAUNCHES == launches + 2 * cfg.max_bounces + 1
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
    launches = tc.LAUNCHES
    t_k, p_k = tc.traverse_cuda(o, d, tmin, tmax, bt0, bp0, *args, leaf=128,
                                any_hit=any_hit)
    t_p, p_p = cl._traverse(o, d, tmin, tmax, bt0, bp0, *args, leaf=128,
                            any_hit=any_hit)
    torch.cuda.synchronize()
    assert tc.LAUNCHES == launches + 1
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
    launches, fused = tc.LAUNCHES, ic.LAUNCHES
    img_k, _ = render_pt(sc, cfg)
    torch.cuda.synchronize()
    assert tc.LAUNCHES == launches + 2 * cfg.max_bounces + 1
    assert ic.LAUNCHES == fused
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
        launches = tc.LAUNCHES
        t_k, p_k = tc.traverse_cuda(*walk_in, *args, leaf=leaf,
                                    any_hit=any_hit)
        t_p, p_p = cl._traverse(*walk_in, *args, leaf=leaf, any_hit=any_hit)
        torch.cuda.synchronize()
        assert tc.LAUNCHES == launches + 1
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
        launches = pc.EXPAND_LAUNCHES
        got = pc.expand_cuda(*rays, cmin, cmax, k=k)
        want = pairs.expand_plain(*rays, cmin, cmax, k=k)
        torch.cuda.synchronize()
        assert pc.EXPAND_LAUNCHES == launches + 1
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
        launches = pc.PAIRTEST_LAUNCHES
        t_k, p_k = pc.pairtest_cuda(*args, leaf=leaf)
        t_p, p_p = pairs.pairtest_plain(*args, leaf=leaf)
        torch.cuda.synchronize()
        assert pc.PAIRTEST_LAUNCHES == launches + 1
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
    before = (pc.EXPAND_LAUNCHES, pc.PAIRTEST_LAUNCHES, tc.LAUNCHES,
              ic.LAUNCHES)
    img_p, _ = render_pt(sc, cfg)
    torch.cuda.synchronize()
    n = 2 * cfg.max_bounces + 1
    assert (pc.EXPAND_LAUNCHES, pc.PAIRTEST_LAUNCHES, tc.LAUNCHES,
            ic.LAUNCHES) == (before[0] + n, before[1] + n, before[2] + n,
                             before[3])
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
    launches, walks = ic.LAUNCHES, tc.LAUNCHES
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")   # nothing may wait on the card
    try:
        L_k, sp_k, st_k = bdpt_through(sc, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert ic.LAUNCHES == launches + 2 * 25 and tc.LAUNCHES == walks
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
    launches, fused = tc.LAUNCHES, ic.LAUNCHES
    L_k, sp_k, _ = bdpt_through(sc, cfg)
    torch.cuda.synchronize()
    assert tc.LAUNCHES == launches + 25 and ic.LAUNCHES == fused
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
    launches, walks = ic.LAUNCHES, tc.LAUNCHES
    loss, grads = grad_render(sc, start, target, cfg, remat=remat)
    torch.cuda.synchronize()
    assert ic.LAUNCHES - launches == (14 if remat else 7)
    assert tc.LAUNCHES == walks
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
