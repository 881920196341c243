"""The top level of the cluster BVH (``accel.toptree``) and kernel B2's
tree walk, on the CPU.

The top level covers every cluster exactly once, each node's box the
exact min and max of its children's, on every clustered scene the port
builds (``make_scene``, ``scene_from_numpy``, the tiling's padding and
shards).  The kernel's tree walk, taken step by step by
``tests/toptree_model.py``, visits the clusters in the plain walk's
(te, c) order and gives ``clustered._traverse``'s (t, prim), closest and
any hit, on rays whose entries tie at te = +-0, on deep walks whose
pending clusters overflow the lanes' buffers (refills), and on a top
level wide enough for the lanes' node buffers to rescan.  The capacity
configuration builds its 1,638,410 triangles into more clusters than the
flat scan stages, and a reduced copy of it renders through ``api.render``
within the mesh cell's limits of the plain reference.
"""

import collections
import dataclasses
import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import face_rays, soup_rays, soup_scene
from toptree_model import FANOUT, flat_walk, tree_walk
from tputracer_torch import trace
from tputracer_torch.accel import clustered as cl
from tputracer_torch.accel import toptree
from tputracer_torch.dist import scene_shard
from tputracer_torch.scene import mesh_scene, scene_from_numpy
from tputracer_torch.scene.types import TENSOR_FIELDS

ROOT = Path(__file__).resolve().parents[1]
BIG = 3.0e38
# what one block's shared memory holds: the flat scan's cluster boxes
FLAT_MAX = 232_448 // 24


@functools.lru_cache(maxsize=None)
def scene(name):
    if name == "mesh":       # 120 clusters of 16 slots: 4 nodes, 24 in the
        return mesh_scene(subdiv=3, leaf_size=16, accel="cluster",  # last
                          device="cpu")
    if name == "wide":       # 6,368 clusters of 4 slots: 199 nodes
        return mesh_scene(subdiv=5, leaf_size=4, accel="cluster",
                          device="cpu")
    sc = soup_scene(20_480, seed=21, device="cpu")   # 160 clusters, each
    if name == "hollow":                  # box spanning most of the cube
        # no slot is valid, so a ray walks every cluster it enters: each
        # lane gets 5 keys, and the walk refills its buffers
        sc = dataclasses.replace(sc, tri_mask=torch.zeros_like(sc.tri_mask))
    return sc


def room_rays(n, seed):
    """Rays from inside the mesh's room in random directions; a quarter
    dead; occlusion distances up to 3."""
    rng = np.random.default_rng(seed)
    o = rng.uniform((-1.9, 0.05, -1.9), (1.9, 2.9, 1.9), (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.full(n, BIG)
    tocc = rng.uniform(0.0, 3.0, n)
    tmax[::4] = tocc[::4] = 0.0
    return tuple(torch.from_numpy(np.asarray(x, np.float32))
                 for x in (o, d, np.zeros(n), tmax, tocc))


def walk_inputs(case, any_hit):
    """(scene, walk inputs (o, d, tmin, tmax, bt0, bp0)) of a ray set."""
    if case in ("soup", "hollow"):
        sc = scene(case)
        o, d, tmin, tmax, tocc = soup_rays(24, seed=22, device="cpu")
    elif case == "faces":
        sc = scene("mesh")
        o, d, tmin, tmax, tocc = face_rays(sc.clus_min, sc.clus_max, 96,
                                           seed=22, device="cpu")
    else:
        sc = scene(case)
        o, d, tmin, tmax, tocc = room_rays(96, seed=23)
    if any_hit:
        tmax = tocc
    bp0 = torch.full(tmax.shape, -1, dtype=torch.int32)
    return sc, (o, d, tmin, tmax, tmax.clone(), bp0)


@pytest.mark.parametrize("name", ["mesh", "wide", "soup"])
def test_top_level_covers_every_cluster_once_with_exact_boxes(name):
    sc = scene(name)
    C, G = sc.n_clusters, sc.top_min.shape[0]
    assert G == -(-C // FANOUT) == -(-C // toptree.FANOUT)
    owner = torch.arange(C) // FANOUT        # node g: clusters 32g .. 32g+31
    assert torch.equal(torch.bincount(owner, minlength=G),
                       torch.tensor([min(FANOUT, C - FANOUT * g)
                                     for g in range(G)]))
    for g in range(G):
        kids = owner == g
        assert torch.equal(sc.top_min[g], sc.clus_min[kids].amin(0))
        assert torch.equal(sc.top_max[g], sc.clus_max[kids].amax(0))
    assert sc.top_min.dtype == sc.top_max.dtype == torch.float32


def test_every_scene_builder_carries_its_top_level():
    """make_scene counts the nodes in its ``scene.bvh`` span; a scene
    from the JAX package's leaves, an unclustered scene and the tiling's
    padded and sharded scenes carry the top level of their own boxes."""
    trace.reset()
    sc = mesh_scene(subdiv=3, leaf_size=16, accel="cluster", device="cpu")
    rec = trace.records("scene.bvh")[-1]
    assert rec.counts == {"clusters": 120, "top_nodes": 4}
    arrays = {f: getattr(sc, f).numpy() for f in TENSOR_FIELDS}
    back = scene_from_numpy(dict(arrays, camera=None), n_tris=sc.n_tris,
                            eps=sc.eps, leaf_size=sc.leaf_size, device="cpu")
    assert torch.equal(back.top_min, sc.top_min)
    assert torch.equal(back.top_max, sc.top_max)
    flat = mesh_scene(subdiv=2, accel="none", device="cpu")
    assert flat.top_min.shape == flat.top_max.shape == (0, 3)
    padded = scene_shard.pad_scene_clusters(sc, 7)        # 120 -> 126
    shard = scene_shard.shard_scene(padded, 1, 7)
    for part in (padded, shard):
        want = toptree.top_boxes(part.clus_min, part.clus_max)
        assert torch.equal(part.top_min, want[0])
        assert torch.equal(part.top_max, want[1])
    assert shard.top_min.shape == (1, 3)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("case", ["mesh", "faces", "wide", "soup",
                                  "hollow"])
def test_tree_walk_visits_the_plain_walks_order(case, any_hit):
    """The kernel's tree walk (the model) visits exactly the plain walk's
    clusters in its order and gives clustered._traverse's (t, prim)."""
    sc, walk_in = walk_inputs(case, any_hit)
    tables = cl.traverse_args(sc)
    t_p, p_p = cl._traverse(*walk_in, *tables, leaf=sc.leaf_size,
                            any_hit=any_hit)
    boxes = 0
    for i in range(walk_in[0].shape[0]):
        t, p, order, counts = tree_walk(i, walk_in, tables, sc.leaf_size,
                                        any_hit)
        assert flat_walk(i, walk_in, tables, sc.leaf_size,
                         any_hit) == (t, p, order)
        assert (t, p) == (float(t_p[i]), int(p_p[i])), i
        boxes += counts[0]
        assert counts[1] == len(order)
        assert counts[2] == int(walk_in[3][i] > walk_in[2][i])
    hits = float((p_p >= 0).float().mean())
    assert hits == 0 if case == "hollow" else hits > 0.05
    # the walk tests far fewer boxes than the flat scan's C a ray, except
    # on the soup, whose every cluster box spans the cube
    live = int((walk_in[3] > walk_in[2]).sum())
    if case in ("mesh", "wide"):
        assert boxes < 0.5 * live * sc.n_clusters


def test_deep_and_wide_walks_take_every_branch():
    """A ray through a hollow soup of 6,424 clusters of four slots in 201
    nodes, every box spanning most of the cube: each lane owns 6 or 7
    admitted nodes, more than its buffer holds, so it rescans them, and
    some 200 pending clusters, so the walk refills their buffers."""
    from tputracer_torch.scene.types import DIFFUSE, make_scene

    tv = np.random.default_rng(21).uniform(-1.0, 1.0, (20_480, 3, 3))
    sc = make_scene(tv.astype(np.float32), np.zeros(20_480, np.int32),
                    [{"kind": DIFFUSE, "albedo": (0.5, 0.5, 0.5)}],
                    accel="cluster", leaf_size=4, device="cpu")
    sc = dataclasses.replace(sc, tri_mask=torch.zeros_like(sc.tri_mask))
    assert (sc.n_clusters, sc.top_min.shape[0]) == (6_424, 201)
    o, d, tmin, tmax, _ = soup_rays(1, seed=22, device="cpu")
    walk_in = (o, d, tmin, tmax, tmax.clone(),
               torch.full((1,), -1, dtype=torch.int32))
    tables = cl.traverse_args(sc)
    assert int((cl.cluster_entries(o, d, tmin, tmax, *tables[6:])
                < BIG).sum()) > 32 * 4
    events = collections.Counter()
    t, p, order, counts = tree_walk(0, walk_in, tables, sc.leaf_size,
                                    events=events)
    assert events["rescan"] > 0 and events["refill"] > 0
    assert (t, p, order) == flat_walk(0, walk_in, tables, sc.leaf_size)
    assert p == -1 and len(order) > 4_000 and counts[1] == len(order)


def capacity_config():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = {c["name"]: c for c in bench["configs"]}["mesh_subdiv8"]
    return json.loads((ROOT / entry["file"]).read_text())


def test_capacity_config_builds_more_clusters_than_the_flat_scan_stages():
    from perfbench import scenes
    from tputracer_torch.accel.bvh import build_clusters

    cfg = capacity_config()
    arrays = scenes.build(cfg)
    assert arrays.tris.shape == (1_638_410, 3, 3) == (cfg["n_triangles"],
                                                      3, 3)
    _, mask, cmin, _ = build_clusters(arrays.tris,
                                      leaf_size=cfg["scene"]["leaf_size"])
    assert int(mask.sum()) == 1_638_410
    assert len(cmin) == 18_304 > FLAT_MAX
    assert -(-len(cmin) // FANOUT) == 572 <= FLAT_MAX


@pytest.mark.parametrize("seed", [2**31 + 99, 12345])
def test_reduced_capacity_copy_matches_the_reference(seed):
    """The capacity configuration with its blobs at subdiv 3 and 2, its
    1,610 triangles clustered, through api.render on the CPU at 24x24,
    4 spp, 8 bounces: within the mesh cell's limits (and the capacity
    cell's) of the plain reference; the control fails them."""
    from perfbench import bench, check, generator, program, scenes

    spec = bench.load(ROOT, "capacity_turntable")
    cfg = dict(spec.config, scene=dict(spec.config["scene"],
                                       accel="cluster"))
    cfg["blobs"] = [dict(b, subdiv=s) for b, s in zip(cfg["blobs"], (3, 2))]
    arrays = scenes.build(cfg)
    tt = generator.Turntable(spec.traffic, cfg["camera"], seed)
    k = 5
    em = generator.material_tables(arrays.materials)["mat_emission"] \
        * tt.factor(k)
    origin = tt.origins[tt.yaw_index(k)]
    sc = program.build_scene(arrays, cfg, "cpu")
    assert sc.n_clusters > 0 and sc.top_min.shape[0] > 0
    sc = program.with_tables(sc, camera=program.camera(cfg["camera"], origin,
                                                       "cpu"),
                             mat_emission=torch.as_tensor(em))
    r = dict(spec.traffic["render"], width=24, height=24, chunk_size=1 << 12)
    img = program.render(sc, program.render_config(r, seed)).numpy()
    assert img.mean() > 1e-2
    pixels = check.pixel_sample(r, 96, seed)
    readings = check.render_readings(
        arrays, cfg, r, seed, [(k, img)], pixels, torch.device("cpu"),
        lambda _: em, lambda _: origin)
    mesh_limits = bench.load(ROOT, "mesh_turntable").cell["limits"]
    for limits in (mesh_limits, spec.cell["limits"]):
        assert check.judge(readings[0], limits)[0], readings
    ctl = check.reference_pixels(arrays, cfg, r, seed, em, origin, pixels,
                                 torch.device("cpu"), torch.bfloat16)
    got = check.image_numbers(ctl, check.reference_pixels(
        arrays, cfg, r, seed, em, origin, pixels, torch.device("cpu"),
        torch.float32))
    assert not check.judge(got, spec.cell["limits"])[0], got


def _launch_records(devices):
    """The program's ``graphs.launch`` records, with these device dicts."""
    trace.reset()
    for dev in devices:
        with trace.span("graphs.launch") as rec:
            pass
        rec.device = dev


def test_walk_counter_readers():
    """b2_nodes_per_ray and b2_visits_per_ray sum the window's replays'
    counts over their rays; a window whose records lack the counts (the
    flat scan, a program without them) reads None."""
    import types

    from perfbench import bench

    nodes = bench.reader("b2_nodes_per_ray")
    visits = bench.reader("b2_visits_per_ray")
    st = types.SimpleNamespace(kind="render", steps_per_unit=1,
                               host={"unit_s": [0.03] * 2})
    _launch_records([{"replay_ms": 9.0, "b2.nodes": [600.0],
                      "b2.visits": [2.0], "b2.rays": [1.0]},
                     {"replay_ms": 9.0, "b2.nodes": [2100.0],
                      "b2.visits": [7.0], "b2.rays": [3.0]}])
    assert nodes(st) == 2700.0 / 4 and visits(st) == 9.0 / 4
    _launch_records([{"replay_ms": 9.0}] * 2)
    assert nodes(st) is None and visits(st) is None
    assert nodes(types.SimpleNamespace(**dict(vars(st), kind="fit"))) \
        is None
    trace.reset()


def test_visit_bound_counts_the_clusters_entered_before_the_hit():
    """visit_work charges each live ray a slab test of each cluster it
    enters before its final hit, and each such cluster's bytes once a
    launch: far less than the flat scan's count, which charges all C."""
    from perfbench import roofline, visit_bound

    sc, (o, d, tmin, tmax, bt0, bp0) = walk_inputs("wide", False)
    args = cl.traverse_args(sc)
    t, _ = cl._traverse(o, d, tmin, tmax, bt0, bp0, *args,
                        leaf=sc.leaf_size)
    ops, nbytes = visit_bound.visit_work(o, d, tmin, tmax, t, args,
                                         sc.leaf_size)
    te = cl.cluster_entries(o, d, tmin, tmax, args[0], args[1])
    seen = (te < t[:, None]) & (tmax > tmin)[:, None]
    V = int(seen.any(0).sum())
    assert nbytes == 4 * (12 * o.shape[0] + 6 * V + 23 * sc.leaf_size * V)
    assert ops >= int(seen.sum()) * (roofline.OPS_SLAB + roofline.OPS_EDGES)
    flat_ops, flat_bytes = roofline.walk_work(o, d, tmin, tmax, t, args,
                                              sc.leaf_size)
    assert ops < 0.1 * flat_ops and nbytes < flat_bytes
