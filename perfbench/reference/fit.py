"""The fit's plain reference: inverse rendering through the reference path
tracer, with Adam written out from its paper (Kingma & Ba, 2015).

From the configuration's true materials it renders its own target, then
takes the fit's first steps from the traffic's start tables: the mean
squared pixel error, its gradients by autograd through the reference's
shading, Adam's update (beta1 0.9, beta2 0.999, eps 1e-8, bias-corrected)
and the projection of each table onto its range.  It reads nothing the
program made.
"""

from __future__ import annotations

import torch

from perfbench import generator
from perfbench.reference import pt as ref

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8
# each table's range after a step: albedo in [0, 1], emission >= 0
RANGES = {"mat_albedo": (0.0, 1.0), "mat_emission": (0.0, None),
          "mat_ior": (1.0, 3.0)}


def mse(img, target):
    return torch.mean((img - target) ** 2)


def first_steps(arrays, config, traffic, seed, device, dtype, steps,
                loss_of=mse):
    """{"losses": the first ``steps`` losses, "grad": each table's first
    gradient's norm, "change": each table's change after the steps}.
    ``loss_of(image, target)`` is the loss (a fault plants another)."""
    r = traffic["render"]
    cam_cfg = config["camera"]
    cam = ref.camera(cam_cfg["o"], cam_cfg["look_at"], cam_cfg["up"],
                     cam_cfg["vfov_deg"], cam_cfg["aspect"], device, dtype)
    eps = config["scene"]["eps"]
    with torch.no_grad():
        target = ref.render_image(
            ref.make_ref_scene(arrays, eps=eps, device=device, dtype=dtype),
            cam, r, seed)
    start = {k: torch.as_tensor(v, device=device).to(dtype)
             for k, v in generator.fit_start(arrays.materials,
                                             traffic).items()}
    params = {k: v.clone().requires_grad_() for k, v in start.items()}
    m = {k: torch.zeros_like(v) for k, v in start.items()}
    v2 = {k: torch.zeros_like(v) for k, v in start.items()}
    losses, first = [], None
    for t in range(1, steps + 1):
        sc = ref.make_ref_scene(
            arrays, eps=eps, device=device, dtype=dtype,
            albedo=params.get("mat_albedo"), emission=params.get(
                "mat_emission"))
        img = ref.render_image(sc, cam, r, seed)
        loss = loss_of(img, target)
        grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: float(torch.linalg.vector_norm(g.float()))
                     for k, g in zip(params, grads)}
        with torch.no_grad():
            for (k, p), g in zip(params.items(), grads):
                m[k] = BETA1 * m[k] + (1 - BETA1) * g
                v2[k] = BETA2 * v2[k] + (1 - BETA2) * g * g
                mh = m[k] / (1 - BETA1 ** t)
                vh = v2[k] / (1 - BETA2 ** t)
                p -= traffic["lr"] * mh / (torch.sqrt(vh) + EPS)
                lo, hi = RANGES.get(k, (None, None))
                p.clamp_(lo, hi)
    change = {k: float(torch.linalg.vector_norm(
        (params[k].detach() - start[k]).float())) for k in params}
    return {"losses": losses, "grad": first, "change": change}
