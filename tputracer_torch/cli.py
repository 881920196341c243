"""CLI entry point (path tracer only):

    python -m tputracer_torch.cli --scene boxes --size 256 --spp 16 \
        --bounces 4 --out out.png

It renders on the card; ``--device cpu`` asks for the CPU.
``--scene mesh`` is BASELINE config 3's 102,410-triangle mesh (cluster
BVH, the traversal kernel on the card), ``--scene mesh_small`` its
5,130-triangle variant, and ``--obj FILE`` renders an OBJ file.

Renders twice (the first call builds the CUDA kernel on first use and
warms up), times the second, writes the image and prints one JSON line
with the same keys as ``python -m tputracer.cli``.
"""

from __future__ import annotations

import argparse
import json
import time


def parser():
    """The CLI's argument parser."""
    ap = argparse.ArgumentParser(prog="tputracer_torch")
    ap.add_argument("--scene", default="boxes",
                    choices=["empty", "boxes", "spheres", "glass_sphere",
                             "caustic", "furnace", "mesh", "mesh_small"])
    ap.add_argument("--obj", default=None,
                    help="render an OBJ file instead of a named scene")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--bounces", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mis", action="store_true")
    ap.add_argument("--out", default="out.png")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on: cuda (the default) or cpu")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)

    import torch

    from tputracer_torch.api import render
    from tputracer_torch.config import RenderConfig
    from tputracer_torch.film import save_image
    from tputracer_torch.scene import (cornell_box, furnace, mesh_scene,
                                       obj_scene)

    device = torch.device(args.device)
    if args.obj:
        scene = obj_scene(args.obj, device=device)
    elif args.scene == "furnace":
        scene = furnace(device=device)
    elif args.scene == "mesh":
        scene = mesh_scene(subdiv=6, device=device)   # 102,410 tris (config 3)
    elif args.scene == "mesh_small":
        scene = mesh_scene(subdiv=4, device=device)
    else:
        scene = cornell_box(args.scene, device=device)
    cfg = RenderConfig(width=args.size, height=args.size, spp=args.spp,
                       max_bounces=args.bounces, seed=args.seed,
                       mis=args.mis)

    def run():
        t0 = time.perf_counter()
        img, _ = render(scene, cfg)
        img = img.cpu().numpy()      # waits for the device
        return img, time.perf_counter() - t0

    _, t_first = run()
    img, dt = run()

    save_image(img, args.out)
    n_paths = args.size * args.size * args.spp
    # closest-hit + shadow segments per path, every lane counted
    rays = n_paths * (args.bounces + 1 + args.bounces)
    print(json.dumps({
        "scene": args.scene, "integrator": "pt",
        "size": args.size, "spp": args.spp, "bounces": args.bounces,
        "compile_s": round(t_first - dt, 3), "render_s": round(dt, 4),
        "rays_per_s": round(rays / dt), "out": args.out,
        "mean": float(img.mean()),
    }))


if __name__ == "__main__":
    main()
