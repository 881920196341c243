"""One rank of a tputracer_torch world for the distribution tests.

    python tests/torch_dist_worker.py --init file:///tmp/x/pg --world 4 \
        --rank 0 --modes sharded --out DIR

Each rank joins a world, gloo unless --backend says otherwise (one
thread, a 60 s process-group timeout),
runs the listed modes and saves what they computed to
``DIR/rank<r>.npz``; the fit modes also print one JSON line a step.  The
test files start the ranks with :func:`run_world`, which kills them all
when its timeout expires, and compare the saved arrays with the JAX
package and with the port's single-process renders.  No JAX here.

Modes (all at the sizes of tests/distributed/):
  sharded  render_sharded at P = 4, on the (2, 2) mesh, and on groups of
           2 and 1 ranks; render_bdpt_sharded; fit_step_sharded and one
           fit_step_opt_sharded step; fit_step_bdpt_sharded
  tiling   render_tiled at P = 4 and (2, 2); the spheres scene, with the
           ring's hit prims against the whole scene's; render_bdpt_tiled
           on the clustered caustic; fit_step_tiled and fit_step_sharded;
           fit(tiled=True)
  ring     render_bdpt_ring at P = 4 and on the (2, 2) mesh
  render   render_sharded of the boxes, printing the image mean
  fit      fit(mesh=) with a checkpoint; rank 1 dies (exit code 42) after
           --crash-at steps when that is set
  bdpt_fit fit_step_bdpt_sharded toward --target (an .npy), printing the
           loss and the gradients' sum
  join     joins the world (with --backend) and leaves it
  card     on the card, the ranks sharing it (tests/test_torch_cuda.py):
           the traversal kernel on recorded ring hops against the plain
           walk, render_tiled of config 3 at 64x64, and a config-5 DP fit
           step at 32x32 toward --target
All modes but "card" run on the CPU.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# the configs of tests/distributed/
PT = dict(width=16, height=16, spp=2, max_bounces=2, rr_start=1,
          chunk_size=16 * 16 * 2)
TILED = dict(width=16, height=16, spp=2, max_bounces=3, rr_start=2,
             chunk_size=16 * 16 * 2)
SPHERES = dict(width=16, height=16, spp=2, max_bounces=4, rr_start=3,
               chunk_size=16 * 16 * 2)
BDPT = dict(width=16, height=16, spp=2, max_bounces=2, chunk_size=16 * 16 * 2)
BDPT3 = dict(BDPT, max_bounces=3)
FIT_PARAMS = (("mat_albedo", 0.6), ("mat_emission", 1.5))


def run_world(modes, world, out_dir, timeout=120, **kw):
    """Run ``world`` ranks of this script (gloo, file:// rendezvous under
    out_dir) and wait for them; every rank still running at ``timeout``
    seconds is killed.  Returns [(returncode, stdout, stderr)] by rank."""
    os.makedirs(out_dir, exist_ok=True)
    init = f"file://{os.path.join(out_dir, 'rendezvous')}"
    procs = [start_rank(modes, world, r, init, out_dir, **kw)
             for r in range(world)]
    return wait_all(procs, timeout)


def start_rank(modes, world, rank, init, out_dir, **kw):
    cmd = [sys.executable, os.path.abspath(__file__), "--init", init,
           "--world", str(world), "--rank", str(rank), "--modes", modes,
           "--out", out_dir]
    for k, v in kw.items():
        cmd += [f"--{k.replace('_', '-')}", str(v)]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def wait_all(procs, timeout):
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            try:
                out, err = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
                err += f"\nkilled after {timeout} s"
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def load(out_dir, rank):
    with np.load(os.path.join(out_dir, f"rank{rank}.npz")) as z:
        return dict(z)


def parse(out):
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


# ---- the modes -------------------------------------------------------------

def _np(x):
    return x.detach().cpu().numpy()


def _fit_params(scene):
    return {k: getattr(scene, k) * s for k, s in FIT_PARAMS}


def mode_sharded(rank, save):
    import torch.distributed as dist

    from tputracer_torch.api import render, render_bdpt
    from tputracer_torch.config import BdptConfig, RenderConfig
    from tputracer_torch.dist import (fit_step_bdpt_sharded,
                                      fit_step_opt_sharded, fit_step_sharded,
                                      make_mesh, render_bdpt_sharded,
                                      render_sharded)
    from tputracer_torch.fit import _adam
    from tputracer_torch.scene import cornell_box

    scene = cornell_box("boxes", device="cpu")
    cfg = RenderConfig(**PT)
    # every rank makes every group, in the same order
    g2, g1 = dist.new_group([0, 1]), dist.new_group([0])
    meshes = {"p4": make_mesh(), "p22": make_mesh((2, 2))}
    if rank < 2:
        meshes["p2"] = make_mesh(group=g2)
    if rank < 1:
        meshes["p1"] = make_mesh(group=g1)
    for name, mesh in meshes.items():
        img, stats = render_sharded(scene, cfg, mesh)
        save[f"{name}_img"] = _np(img)
        for k, v in stats.items():
            save[f"{name}_{k}"] = _np(v)
    mesh = meshes["p4"]
    bcfg = BdptConfig(**BDPT)
    save["bdpt_img"] = _np(render_bdpt_sharded(scene, bcfg, mesh))

    target = render(scene, cfg)[0]
    save["fit_target"] = _np(target)
    params = _fit_params(scene)
    loss, grads = fit_step_sharded(scene, params, target, cfg, mesh)
    save["fit_loss"] = _np(loss)
    for k, v in grads.items():
        save[f"fit_grad_{k}"] = _np(v)
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    opt = _adam(list(p.values()), 5e-2)
    save["opt_loss"] = _np(fit_step_opt_sharded(scene, p, target, cfg, mesh,
                                                opt))
    for k, v in p.items():
        save[f"opt_{k}"] = _np(v)

    b_target = render_bdpt(scene, bcfg)[0]
    save["bdpt_target"] = _np(b_target)
    b_params = {"mat_albedo": scene.mat_albedo * 0.6}
    loss, grads = fit_step_bdpt_sharded(scene, b_params, b_target, bcfg,
                                        mesh)
    save["bdpt_fit_loss"] = _np(loss)
    save["bdpt_fit_grad_mat_albedo"] = _np(grads["mat_albedo"])


def mode_tiling(rank, save):
    import torch

    from tputracer_torch.accel import intersect_clustered
    from tputracer_torch.api import render
    from tputracer_torch.config import BdptConfig, RenderConfig
    from tputracer_torch.dist import (fit_step_sharded, fit_step_tiled,
                                      make_mesh, render_bdpt_tiled,
                                      render_tiled)
    from tputracer_torch.dist.mesh import shard_uids
    from tputracer_torch.dist.scene_shard import (make_ring_backends,
                                                  pad_scene_clusters,
                                                  shard_scene)
    from tputracer_torch.fit import fit
    from tputracer_torch.integrators.pt import camera_rays
    from tputracer_torch.scene import cornell_box, mesh_scene

    scene = mesh_scene(subdiv=4, leaf_size=32, accel="cluster", device="cpu")
    cfg = RenderConfig(**TILED)
    mesh = make_mesh()
    for name, m in (("p4", mesh), ("p22", make_mesh((2, 2)))):
        img, stats = render_tiled(scene, cfg, m)
        save[f"{name}_img"] = _np(img)
        for k, v in stats.items():
            save[f"{name}_{k}"] = _np(v)

    sph = cornell_box("spheres", accel="cluster", leaf_size=4, device="cpu")
    scfg = RenderConfig(**SPHERES)
    img, stats = render_tiled(sph, scfg, mesh)
    save["sph_img"] = _np(img)
    save["sph_rays_shadow"] = _np(stats["rays_shadow"])
    # the ring's hits of this rank's camera rays against the whole scene's
    tile = shard_scene(pad_scene_clusters(sph, mesh.size), rank, mesh.size)
    isect, _ = make_ring_backends(mesh)
    o, d = camera_rays(sph, shard_uids(scfg, mesh, "cpu"), scfg)
    zeros, far = torch.zeros(len(o)), torch.full((len(o),), 3.0e38)
    ring_hit = isect(tile, o, d, zeros, far)
    whole_hit = intersect_clustered(pad_scene_clusters(sph, mesh.size), o, d,
                                    zeros, far)
    for k in ("prim", "t", "n", "mat"):
        save[f"sph_ring_{k}"] = _np(getattr(ring_hit, k))
        save[f"sph_whole_{k}"] = _np(getattr(whole_hit, k))

    caustic = cornell_box("caustic", accel="cluster", leaf_size=4,
                          device="cpu")
    save["bdpt_img"] = _np(render_bdpt_tiled(caustic, BdptConfig(**BDPT3),
                                             mesh))

    target = render(scene, cfg)[0]
    save["fit_target"] = _np(target)
    params = _fit_params(scene)
    for name, step in (("tiled", fit_step_tiled), ("dp", fit_step_sharded)):
        loss, grads = step(scene, params, target, cfg, mesh)
        save[f"fit_{name}_loss"] = _np(loss)
        for k, v in grads.items():
            save[f"fit_{name}_grad_{k}"] = _np(v)
    off = {"mat_albedo": torch.clamp(scene.mat_albedo * 0.5, 0.05, 0.95)}
    _, _, hist = fit(scene, target, cfg=cfg, steps=4, learning_rate=5e-2,
                     init=off, log_every=0, steps_per_dispatch=2, mesh=mesh,
                     tiled=True)
    save["fit_tiled_losses"] = np.array([h["loss"] for h in hist])


def mode_ring(rank, save):
    from tputracer_torch.config import BdptConfig
    from tputracer_torch.dist import make_mesh, render_bdpt_ring
    from tputracer_torch.scene import cornell_box

    scene = cornell_box("caustic", device="cpu")
    cfg = BdptConfig(**BDPT3)
    for name, m in (("p4", make_mesh()), ("p22", make_mesh((2, 2)))):
        save[f"{name}_img"] = _np(render_bdpt_ring(scene, cfg, m))


def mode_render(rank, save):
    from tputracer_torch.config import RenderConfig
    from tputracer_torch.dist import make_mesh, render_sharded
    from tputracer_torch.scene import cornell_box

    img, _ = render_sharded(cornell_box("boxes", device="cpu"),
                            RenderConfig(**PT), make_mesh())
    print(json.dumps({"mode": "render", "rank": rank,
                      "mean": float(img.mean())}), flush=True)


def mode_fit(rank, save, steps, crash_at, checkpoint):
    from tputracer_torch.dist import make_mesh, render_sharded
    from tputracer_torch.config import RenderConfig
    from tputracer_torch.fit import fit
    from tputracer_torch.scene import cornell_box

    scene = cornell_box("boxes", device="cpu")
    cfg = RenderConfig(**PT)
    mesh = make_mesh()
    target, _ = render_sharded(scene, cfg, mesh)
    kw = dict(cfg=cfg, learning_rate=1e-1, param_names=("mat_albedo",),
              init={"mat_albedo": scene.mat_albedo * 0.5}, log_every=0,
              steps_per_dispatch=1, checkpoint_every=1, mesh=mesh,
              checkpoint_path=checkpoint or None)
    if crash_at >= 0:
        fit(scene, target, steps=crash_at, **kw)
        if rank == 1:
            os._exit(42)        # a rank lost mid-fit
    _, params, hist = fit(scene, target, steps=steps, **kw)
    for h in hist:
        print(json.dumps({"mode": "fit", "rank": rank, **h}), flush=True)
    albedo = params["mat_albedo"]
    print(json.dumps({"mode": "fit_done", "rank": rank,
                      "albedo_sum": float(albedo.sum())}), flush=True)
    save["albedo"] = _np(albedo)


def mode_bdpt_fit(rank, save, target):
    import torch

    from tputracer_torch.config import BdptConfig
    from tputracer_torch.dist import fit_step_bdpt_sharded, make_mesh
    from tputracer_torch.scene import cornell_box

    scene = cornell_box("boxes", device="cpu")
    params = {"mat_albedo": scene.mat_albedo * 0.6}
    loss, grads = fit_step_bdpt_sharded(
        scene, params, torch.from_numpy(np.load(target)),
        BdptConfig(**BDPT), make_mesh())
    print(json.dumps({"mode": "bdpt_fit", "rank": rank, "loss": float(loss),
                      "grad_sum": float(sum(g.sum()
                                            for g in grads.values()))}),
          flush=True)


def mode_card(rank, save, target):
    import torch

    from chip_smoke import (FIT_CFG, MESH_CFG, fit_start, hold_hop,
                            record_hops)
    from tputracer_torch.config import RenderConfig
    from tputracer_torch.dist import fit_step_sharded, make_mesh, render_tiled
    from tputracer_torch.dist.scene_shard import _tile
    from tputracer_torch.scene import cornell_box, mesh_scene

    mesh = make_mesh()
    scene = mesh_scene(subdiv=6, device="cpu")
    cfg = RenderConfig(**dict(MESH_CFG, width=64, height=64))
    img, stats = render_tiled(scene, cfg, mesh, device="cuda")
    save["tiled_img"] = _np(img)
    for k in ("rays_closest", "rays_shadow"):
        save[f"tiled_{k}"] = _np(stats[k])
    P = mesh.size
    calls = record_hops(mesh, _tile(scene, mesh, "cuda"), cfg)
    # every second hop: rays of the other rank with its carry
    hops = [hold_hop(c) for c in calls[1::P]]
    save["hop_bitwise"] = np.array([h["bitwise"] for h in hops])
    save["hop_carried"] = np.array([h["carried"] for h in hops])

    boxes = cornell_box("boxes", device="cuda")
    fcfg = RenderConfig(**dict(FIT_CFG, width=32, height=32))
    loss, grads = fit_step_sharded(
        boxes, fit_start(boxes), torch.from_numpy(np.load(target)).cuda(),
        fcfg, mesh)
    save["fit_loss"] = _np(loss)
    for k, v in grads.items():
        save[f"fit_grad_{k}"] = _np(v)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--init", required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--modes", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--crash-at", type=int, default=-1)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--target", default="")
    ap.add_argument("--backend", default="gloo")
    args = ap.parse_args()

    import torch

    torch.set_num_threads(1)
    from tputracer_torch.dist import launch

    launch.initialize(args.init, args.world, args.rank, backend=args.backend,
                      timeout_s=60)
    save = {}
    for mode in args.modes.split(","):
        if mode == "fit":
            mode_fit(args.rank, save, args.steps, args.crash_at,
                     args.checkpoint)
        elif mode == "bdpt_fit":
            mode_bdpt_fit(args.rank, save, args.target)
        elif mode == "card":
            mode_card(args.rank, save, args.target)
        elif mode == "join":
            pass
        else:
            globals()[f"mode_{mode}"](args.rank, save)
    np.savez(os.path.join(args.out, f"rank{args.rank}.npz"), **save)
    launch.shutdown()


if __name__ == "__main__":
    main()
