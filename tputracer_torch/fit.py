"""Inverse rendering: fit scene parameters to a target image.

Port of ``tputracer/fit.py``: recover albedo and emitter intensity by
gradient descent through the renderer, on torch.autograd.

  * parameters = any differentiable Scene tables (mat_albedo,
    mat_emission, mat_ior); gradients flow through the detached-sampling
    estimator, and the intersection kernels are detached, so none needs
    a backward pass;
  * the optimizer is ``torch.optim.Adam`` with optax.adam's constants
    (betas (0.9, 0.999), eps 1e-8, the same update formula), in its
    single-tensor loop (``foreach=False``), whose order of operations
    decides the last bits of every step;
  * checkpoint/resume: an ``.npz`` of the step, the parameters and the
    optimizer's per-parameter state.  A resumed run reproduces the
    uninterrupted one because the render's RNG is keyed by the path uid,
    not by the wall clock or a generator's state.

With ``mesh=`` (``tputracer_torch.dist``) every rank of the world runs the
same fit: rays sharded over the mesh, the loss and gradients all-reduced,
so every rank takes the same Adam steps; ``tiled=True`` also splits the
geometry over the ranks.  Rank 0 alone writes the checkpoint and the logs.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from tputracer_torch.api import _loss_and_grads

DEFAULT_PARAMS = ("mat_albedo", "mat_emission")

# projection ranges keeping parameters physical during optimization
_PARAM_RANGES = {
    "mat_albedo": (0.0, 1.0),
    "mat_emission": (0.0, None),
    "mat_ior": (1.0, 3.0),
}


def _project(params):
    """Clamp each parameter to its range, in place."""
    with torch.no_grad():
        for k, v in params.items():
            lo, hi = _PARAM_RANGES.get(k, (None, None))
            if lo is not None or hi is not None:
                v.clamp_(lo, hi)


def _render_for(integrator):
    """The fit loss's forward renderer.  "bdpt" differentiates through
    integrators.bdpt.render_bdpt: the t=1 ``index_add_`` splat (whose
    backward is a gather) and the MIS ratio chains are plain torch ops."""
    if integrator == "bdpt":
        from tputracer_torch.integrators.bdpt import render_bdpt

        return render_bdpt
    if integrator == "pt":
        from tputracer_torch.integrators.pt import render_pt

        return render_pt
    raise ValueError(f"integrator must be 'pt' or 'bdpt', got {integrator!r}")


def _single_step(scene, params, target, cfg, integrator):
    """(loss, grads) of the mean squared pixel error on one device: a 0-d
    tensor and a dict with the keys of ``params``, all on the device."""
    return _loss_and_grads(_render_for(integrator), scene, params, target,
                           cfg)


def chain_steps(step_fn, scene, params, target, opt, n_steps):
    """The K-step optimizer loop: returns the (n_steps,) losses, on the
    device; nothing in it waits on the device.

    step_fn(scene, params, target) -> (loss, grads).  It must apply
    params to the scene itself, which is what puts them into the autograd
    graph.  ``params`` is the dict of leaf tensors that ``opt`` steps,
    updated in place and projected after each step."""
    losses = []
    for _ in range(n_steps):
        loss, grads = step_fn(scene, params, target)
        for k, v in params.items():
            v.grad = grads[k]
        opt.step()
        opt.zero_grad(set_to_none=True)
        _project(params)
        losses.append(loss)
    return torch.stack(losses)


def _fit_step_single(scene, params, target, cfg, opt, integrator="pt"):
    """One optimization step on one device: its loss (0-d, on the device)."""
    return _fit_chain_single(scene, params, target, cfg, opt, 1,
                             integrator)[0]


def _fit_chain_single(scene, params, target, cfg, opt, n_steps,
                      integrator="pt"):
    """n_steps optimization steps on one device: (n_steps,) losses."""
    return chain_steps(
        lambda sc, p, t: _single_step(sc, p, t, cfg, integrator),
        scene, params, target, opt, n_steps)


def _chain_for(mesh, tiled, integrator):
    """The fit's chain of steps: chain(scene, params, target, cfg, opt, k)
    -> (k,) losses."""
    if mesh is None:
        return lambda sc, p, t, cfg, opt, k: _fit_chain_single(
            sc, p, t, cfg, opt, k, integrator)
    from tputracer_torch import dist

    if tiled:
        fn = dist.fit_chain_tiled
    elif integrator == "bdpt":
        fn = dist.fit_chain_bdpt_sharded
    else:
        fn = dist.fit_chain_sharded
    return lambda sc, p, t, cfg, opt, k: fn(sc, p, t, cfg, mesh, opt, k)


def _adam(params_list, lr):
    return torch.optim.Adam(params_list, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            foreach=False)


def save_checkpoint(path, step, params, opt):
    """``.npz`` checkpoint: ``step``, ``names`` (the parameter names in
    order), ``param_<name>`` for each parameter and ``opt_<i>_<key>`` for
    each entry of the optimizer's state of parameter i (Adam: ``step``,
    ``exp_avg``, ``exp_avg_sq``).  Written to a temporary file and renamed,
    so a crash never leaves half a checkpoint."""
    arrs = {f"param_{k}": v.detach().cpu().numpy() for k, v in params.items()}
    for i, state in opt.state_dict()["state"].items():
        for key, val in state.items():
            arrs[f"opt_{i}_{key}"] = torch.as_tensor(val).cpu().numpy()
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, step=step, names=np.array(list(params)), **arrs)
    os.replace(tmp, path)


def load_checkpoint(path, params, opt):
    """Restore the parameters (in place) and the optimizer's state from a
    :func:`save_checkpoint` file; returns the step.  A checkpoint of other
    parameters raises ValueError."""
    with np.load(path) as z:
        names = [str(x) for x in z["names"]]
        if names != list(params):
            raise ValueError(f"checkpoint {path} holds parameters {names}, "
                             f"this fit {list(params)}")
        with torch.no_grad():
            for k, v in params.items():
                v.copy_(torch.from_numpy(z[f"param_{k}"]))
        state = {}
        for key in z.files:
            if key.startswith("opt_"):
                _, i, name = key.split("_", 2)
                state.setdefault(int(i), {})[name] = torch.from_numpy(z[key])
        sd = opt.state_dict()
        sd["state"] = state
        opt.load_state_dict(sd)   # moves the state to the parameters' device
        return int(z["step"])


def fit(
    scene,
    target,
    param_names=DEFAULT_PARAMS,
    cfg=None,
    steps=100,
    learning_rate=5e-2,
    optimizer=None,
    mesh=None,
    init=None,
    checkpoint_path=None,
    checkpoint_every=25,
    resume=True,
    log_every=10,
    log_file=None,
    tensorboard_dir=None,
    steps_per_dispatch=8,
    integrator="pt",
    tiled=False,
):
    """Gradient-descend scene parameters toward a target image.

    Returns (fitted_scene, params, history): the scene with the fitted
    tables, the dict of fitted tensors, and a list of {"step": i, "loss":
    v} dicts.  Also a JSONL line per step (log_file), a printed line every
    log_every steps, and TensorBoard scalars (tensorboard_dir: loss, step
    time, steps/s, each parameter's mean |value|).

    optimizer: a callable params_list -> torch.optim.Optimizer; the
    default is Adam at ``learning_rate`` (see the module docstring).
    init: a dict of starting tables; its keys replace param_names.

    steps_per_dispatch: the losses stay on the device, and the host reads
    them once per chain of that many steps.  Chain boundaries snap to the
    checkpoint_every grid, so a resumed run takes the same chains as an
    uninterrupted one with the same checkpoint config, and reproduces it.

    integrator: "pt" (default) or "bdpt", the renderer the loss
    differentiates through ("bdpt" needs a BdptConfig cfg).  The fit runs
    on the scene's device: the card unless the builder was asked for the
    CPU.

    mesh: a ``dist.make_mesh`` mesh; every rank of it calls fit with the
    same arguments.  Rays are sharded over it
    (``dist.fit_chain_sharded``, or ``dist.fit_chain_bdpt_sharded`` for
    "bdpt", whose t=1 splat gradient crosses the ranks); tiled=True (needs
    mesh=, integrator="pt" and a clustered scene) also splits the
    geometry, C/P clusters a rank (``dist.fit_chain_tiled``).  Rank 0
    alone writes checkpoint_path, log_file, TensorBoard and the printed
    lines; every rank resumes from checkpoint_path.
    """
    from tputracer_torch.config import BdptConfig, RenderConfig

    if tiled and (mesh is None or integrator != "pt"):
        raise ValueError("fit(tiled=True) needs mesh= and integrator='pt'")
    _render_for(integrator)
    dev = scene.device
    if integrator == "bdpt":
        cfg = cfg or BdptConfig(width=64, height=64, spp=8, max_bounces=3)
    else:
        cfg = cfg or RenderConfig(width=64, height=64, spp=8, max_bounces=3)
    target = torch.as_tensor(target, dtype=torch.float32, device=dev)
    start_values = (dict(init) if init
                    else {k: getattr(scene, k) for k in param_names})
    params = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
              .detach().clone().requires_grad_()
              for k, v in start_values.items()}
    make_opt = optimizer or (lambda ps: _adam(ps, learning_rate))
    opt = make_opt(list(params.values()))
    step = 0
    if checkpoint_path and resume and os.path.exists(checkpoint_path):
        step = load_checkpoint(checkpoint_path, params, opt)
    chain = _chain_for(mesh, tiled, integrator)
    lead = mesh is None or mesh.rank == 0   # the rank that writes
    if not lead:
        log_file = tensorboard_dir = None
        log_every = 0

    history = []
    logf = open(log_file, "a") if log_file else None
    tb = None
    try:
        if tensorboard_dir:
            from torch.utils.tensorboard import SummaryWriter

            tb = SummaryWriter(tensorboard_dir)
        t_last = time.perf_counter()
        while step < steps:
            k = max(1, min(steps_per_dispatch, steps - step))
            if checkpoint_path and checkpoint_every:
                nxt = (step // checkpoint_every + 1) * checkpoint_every
                k = min(k, nxt - step)
            losses = chain(scene, params, target, cfg, opt, k).tolist()
            for i, lv in enumerate(losses):
                rec = {"step": step + i, "loss": lv}
                history.append(rec)
                if logf:
                    logf.write(json.dumps(rec) + "\n")
                if log_every and (step + i) % log_every == 0:
                    print(f"fit step {step + i}: loss {lv:.6f}")
            if tb:
                now = time.perf_counter()
                last = step + len(losses) - 1
                for i, lv in enumerate(losses):
                    tb.add_scalar("fit/loss", lv, step + i)
                tb.add_scalar("fit/step_seconds",
                              (now - t_last) / len(losses), last)
                tb.add_scalar("fit/steps_per_s",
                              len(losses) / max(now - t_last, 1e-9), last)
                t_last = now
                for name, v in params.items():
                    tb.add_scalar(f"fit/{name}_mean_abs",
                                  float(v.detach().abs().mean()), last)
            step += len(losses)
            if lead and checkpoint_path and checkpoint_every and (
                    step % checkpoint_every == 0 or step == steps):
                save_checkpoint(checkpoint_path, step, params, opt)
    finally:
        if logf:
            logf.close()
        if tb:
            tb.close()
    fitted = {k: v.detach() for k, v in params.items()}
    return dataclasses.replace(scene, **fitted), fitted, history
