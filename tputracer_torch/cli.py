"""CLI entry point:

    python -m tputracer_torch.cli --scene boxes --integrator pt \
        --size 256 --spp 16 --bounces 4 --out out.png

It renders on the card; ``--device cpu`` asks for the CPU.
``--integrator bdpt`` renders with the bidirectional path tracer
(BASELINE config 4 is ``--scene caustic --integrator bdpt --size 128
--spp 8``).  ``--scene mesh`` is BASELINE config 3's 102,410-triangle mesh
(cluster BVH, the traversal kernel on the card), ``--scene mesh_small``
its 5,130-triangle variant, and ``--obj FILE`` renders an OBJ file.

``--tiled`` splits the geometry over a world of ranks (``dist.render_tiled``,
the scene forced into a cluster BVH; PT only): every rank holds C/P
clusters and the rays go round the ring.  Under ``torchrun`` the world is
torchrun's (``env://``; ``--backend``: gloo for ranks that share a card or
run on the CPU, the default, nccl for a card a rank, each rank on the card
of its LOCAL_RANK); without it, a world of one:

    torchrun --nproc-per-node 2 -m tputracer_torch.cli --scene mesh --tiled

Renders twice (the first call builds the CUDA kernels on first use and
warms up), times the second, writes the image (scaled by ``--exposure``)
and prints one JSON line with the same keys as ``python -m
tputracer.cli``.  ``--profile DIR`` writes a torch.profiler trace of the
timed render to DIR/trace.json.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def parser():
    """The CLI's argument parser."""
    ap = argparse.ArgumentParser(prog="tputracer_torch")
    ap.add_argument("--scene", default="boxes",
                    choices=["empty", "boxes", "spheres", "glass_sphere",
                             "caustic", "furnace", "mesh", "mesh_small"])
    ap.add_argument("--obj", default=None,
                    help="render an OBJ file instead of a named scene")
    ap.add_argument("--integrator", default="pt", choices=["pt", "bdpt"])
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--bounces", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mis", action="store_true")
    ap.add_argument("--exposure", type=float, default=1.0)
    ap.add_argument("--out", default="out.png")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the timed render "
                         "to DIR/trace.json")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on: cuda (the default) or cpu")
    ap.add_argument("--tiled", action="store_true",
                    help="split the geometry over the ranks of the world "
                         "(torchrun's, else a world of one) and send the "
                         "rays round the ring; PT only")
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"],
                    help="the world's backend with --tiled: gloo (the "
                         "default) on the CPU or for ranks that share a "
                         "card, nccl for a card a rank")
    return ap


def _join_world(backend):
    """Join torchrun's world (RANK, WORLD_SIZE in the environment) or form
    a world of one in a temporary directory; returns the directory to
    remove, or None."""
    import tempfile

    import torch

    from tputracer_torch.dist import launch

    if "WORLD_SIZE" in os.environ:
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        launch.initialize("env://", int(os.environ["WORLD_SIZE"]),
                          int(os.environ["RANK"]), backend=backend)
        return None
    tmp = tempfile.TemporaryDirectory()
    launch.initialize(f"file://{tmp.name}/world", 1, 0, backend=backend)
    return tmp


def main(argv=None):
    args = parser().parse_args(argv)

    import torch

    from tputracer_torch.api import render, render_bdpt
    from tputracer_torch.config import BdptConfig, RenderConfig
    from tputracer_torch.film import save_image
    from tputracer_torch.scene import (cornell_box, furnace, mesh_scene,
                                       obj_scene)

    device = torch.device(args.device)
    if args.tiled and args.integrator != "pt":
        raise SystemExit("--tiled is PT only: BDPT shards rays, not geometry "
                         "(dist.render_bdpt_sharded)")
    if args.tiled and args.scene == "furnace" and not args.obj:
        raise SystemExit("--tiled: the furnace scene is not clustered")
    # --tiled splits cluster-major geometry: force the cluster BVH, and
    # build on the host, so that only each rank's tile goes to the device
    kw = (dict(accel="cluster", device="cpu") if args.tiled
          else dict(device=device))
    if args.obj:
        scene = obj_scene(args.obj, **kw)
    elif args.scene == "furnace":
        scene = furnace(device=device)
    elif args.scene == "mesh":
        scene = mesh_scene(subdiv=6, **kw)   # 102,410 tris (config 3)
    elif args.scene == "mesh_small":
        scene = mesh_scene(subdiv=4, **kw)
    else:
        scene = cornell_box(args.scene, **kw)
    world = lead = None
    if args.tiled:
        from tputracer_torch.dist import launch, make_mesh, render_tiled

        world = _join_world(args.backend)
        mesh = make_mesh()
        lead = mesh.rank == 0
    if args.integrator == "pt":
        cfg = RenderConfig(width=args.size, height=args.size, spp=args.spp,
                           max_bounces=args.bounces, seed=args.seed,
                           mis=args.mis)
        run_render = render
        if args.tiled:
            def run_render(scene, cfg):
                return render_tiled(scene, cfg, mesh, device=device)
    else:
        cfg = BdptConfig(width=args.size, height=args.size, spp=args.spp,
                         max_bounces=args.bounces, seed=args.seed)
        run_render = render_bdpt

    def run():
        t0 = time.perf_counter()
        img, _ = run_render(scene, cfg)
        img = img.cpu().numpy()      # waits for the device
        return img, time.perf_counter() - t0

    try:
        _, t_first = run()
        if args.profile:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            with torch.profiler.profile(activities=acts) as prof:
                img, dt = run()
            if lead is not False:
                os.makedirs(args.profile, exist_ok=True)
                prof.export_chrome_trace(
                    os.path.join(args.profile, "trace.json"))
        else:
            img, dt = run()
    finally:
        if args.tiled:
            launch.shutdown()
        if world is not None:
            world.cleanup()
    if lead is False:
        return

    save_image(img, args.out, exposure=args.exposure)
    n_paths = args.size * args.size * args.spp
    # closest-hit + shadow segments per path, every lane counted; the JAX
    # CLI counts a BDPT path the same way
    rays = n_paths * (args.bounces + 1 + args.bounces)
    print(json.dumps({
        "scene": args.scene, "integrator": args.integrator,
        "size": args.size, "spp": args.spp, "bounces": args.bounces,
        "tiled": args.tiled,
        "compile_s": round(t_first - dt, 3), "render_s": round(dt, 4),
        "rays_per_s": round(rays / dt), "out": args.out,
        "mean": float(img.mean()),
    }))


if __name__ == "__main__":
    main()
