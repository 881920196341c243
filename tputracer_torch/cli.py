"""CLI entry point (path tracer only):

    python -m tputracer_torch.cli --scene boxes --size 256 --spp 16 \
        --bounces 4 --device cuda --out out.png

Renders twice (the first call builds the CUDA kernel on first use and
warms up), times the second, writes the image and prints one JSON line
with the same keys as ``python -m tputracer.cli``.
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tputracer_torch")
    ap.add_argument("--scene", default="boxes",
                    choices=["empty", "boxes", "spheres", "glass_sphere",
                             "caustic", "furnace"])
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--bounces", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mis", action="store_true")
    ap.add_argument("--out", default="out.png")
    ap.add_argument("--device", default="cpu",
                    help="torch device to render on, e.g. cuda or cpu")
    args = ap.parse_args(argv)

    import torch

    from tputracer_torch.api import render
    from tputracer_torch.config import RenderConfig
    from tputracer_torch.film import save_image
    from tputracer_torch.scene import cornell_box, furnace

    device = torch.device(args.device)
    if args.scene == "furnace":
        scene = furnace(device=device)
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
