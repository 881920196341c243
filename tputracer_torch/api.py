"""Public API: ``render`` (wavefront path tracer), ``render_bdpt``
(bidirectional path tracer), their progressive forms with film
checkpoints, ``render_progressive`` and ``render_bdpt_progressive``, and
``grad_render`` (a pixel loss and its gradients).

The render entry points go through the JAX package's compiled functions'
counterparts, under their names: ``_render_jit``, ``_render_bdpt_jit``,
``_progressive_pass_jit`` and ``_progressive_bdpt_pass_jit``.  On the card
each runs eagerly on the first call of a config (and pass size) and scene
layout, captures a CUDA graph on the second and replays it after
(tputracer_torch.graphs); the scene is copied in at each replay, so
material and light edits do not capture again.  On the CPU they run
eagerly.  The eager functions stay reachable as
``integrators.pt.render_pt``, ``integrators.bdpt.render_bdpt``,
``trace_chunked`` and ``trace_bdpt_rows``."""

from __future__ import annotations

import dataclasses
import hashlib
import os

import numpy as np
import torch

from tputracer_torch import graphs
from tputracer_torch.config import BdptConfig, RenderConfig
from tputracer_torch.trace import span


def _with(cfg, default, kw):
    return (cfg or default()).with_(**kw) if kw or cfg is None else cfg


def render(scene, cfg: RenderConfig | None = None, *, device=None, **kw):
    """Render with the wavefront path tracer. Returns (image, stats).

    image is an (H,W,3) float32 tensor (row 0 = top) and stats a dict of
    per-bounce ray counts, both on the render's device.  ``device`` moves
    the scene there first (None keeps the scene's own device); keyword
    arguments override fields of ``cfg``.
    """
    cfg = _with(cfg, RenderConfig, kw)
    if device is not None:
        scene = scene.to(device)
    return _render_jit(scene, cfg)


def _render_jit(scene, cfg):
    """render_pt(scene, cfg) as a CUDA graph keyed on cfg (graphs.call)."""
    from tputracer_torch.integrators.pt import render_pt

    return graphs.call("_render_jit", lambda sc: render_pt(sc, cfg), scene,
                       cfg)


def render_bdpt(scene, cfg: BdptConfig | None = None, *, device=None, **kw):
    """Render with the bidirectional path tracer. Returns (image, stats).

    image is an (H,W,3) float32 tensor (row 0 = top); stats holds the
    closest-hit and shadow rays traced and the t=1 splat film's energy,
    as tensors on the render's device.  ``device`` and keyword arguments
    as in :func:`render`.
    """
    cfg = _with(cfg, BdptConfig, kw)
    if device is not None:
        scene = scene.to(device)
    return _render_bdpt_jit(scene, cfg)


def _render_bdpt_jit(scene, cfg):
    """integrators.bdpt.render_bdpt(scene, cfg) as a CUDA graph keyed on
    cfg (graphs.call)."""
    from tputracer_torch.integrators.bdpt import render_bdpt as _rb

    return graphs.call("_render_bdpt_jit", lambda sc: _rb(sc, cfg), scene,
                       cfg)


def _pass_uids(cfg, offset, step, device):
    """The uids of samples [offset, offset + step) of every pixel, pixel by
    pixel: the global ids the single-shot render gives those samples.
    offset is a (1,) int64 tensor on ``device`` (as JAX's, so that a graph
    takes it as an input) or an int."""
    pix = torch.arange(cfg.width * cfg.height, dtype=torch.int64,
                       device=device)[:, None]
    return (pix * cfg.spp + offset
            + torch.arange(step, dtype=torch.int64, device=device)[None, :]
            ).reshape(-1)


def _pt_pass(scene, cfg, offset, step):
    """Film-sum contribution (H,W,3) of one path-tracing pass, uid rows:
    _progressive_pass_jit's eager body."""
    from tputracer_torch.integrators.pt import trace_chunked

    L, _ = trace_chunked(scene, _pass_uids(cfg, offset, step, scene.device),
                         cfg)
    return L.reshape(cfg.height, cfg.width, step, 3).sum(dim=2)


def _bdpt_pass(scene, cfg, offset, step):
    """Film-sum contribution (H,W,3) of one BDPT pass, uid rows:
    _progressive_bdpt_pass_jit's eager body."""
    from tputracer_torch.integrators.bdpt import trace_bdpt_rows

    # samples_per_pixel=step: the uids hold a slice of each pixel's samples
    L_own, splat, _ = trace_bdpt_rows(
        scene, _pass_uids(cfg, offset, step, scene.device), cfg,
        samples_per_pixel=step)
    own = L_own.reshape(cfg.height, cfg.width, step, 3).sum(dim=2)
    # single-shot film = L_sum/spp + splat_sum/(n_pix*spp)
    #                  = (L_sum + splat_sum/n_pix) / spp, so each pass adds
    # its splat scaled by 1/n_pix into the same accumulator
    n_pix = cfg.width * cfg.height
    return own + splat.reshape(cfg.height, cfg.width, 3) / float(n_pix)


def _progressive_pass_jit(scene, offset, step, cfg):
    """_pt_pass as a CUDA graph keyed on (step, cfg), offset (1,) int64
    copied in at each call: one graph serves every full pass."""
    return graphs.call(
        "_progressive_pass_jit",
        lambda sc, off: _pt_pass(sc, cfg, off, step), scene, (step, cfg),
        offset)


def _progressive_bdpt_pass_jit(scene, offset, step, cfg):
    """_bdpt_pass as a CUDA graph keyed on (step, cfg), as
    :func:`_progressive_pass_jit`."""
    return graphs.call(
        "_progressive_bdpt_pass_jit",
        lambda sc, off: _bdpt_pass(sc, cfg, off, step), scene, (step, cfg),
        offset)


def _ckpt_ident(scene, cfg):
    """Checkpoint identity: a film from another render must never blend
    in, so a resume needs the same package, integrator, estimator flags,
    scene and config.

    sha256 (not hash(), which is salted per process) of this package's
    name, then every scene tensor in Scene's field order and the camera's,
    then type(cfg).__name__ and the flags (mis, mis_power, rr_start,
    transport_radiance).  The package's name makes a checkpoint written by
    the JAX package (whose films differ from this one's in the last bits)
    a mismatch."""
    from tputracer_torch.scene.types import CAMERA_FIELDS, TENSOR_FIELDS

    dig = hashlib.sha256(b"tputracer_torch")
    for t in ([getattr(scene, f) for f in TENSOR_FIELDS]
              + [getattr(scene.camera, f) for f in CAMERA_FIELDS]):
        dig.update(t.detach().cpu().numpy().tobytes())
    dig.update(type(cfg).__name__.encode())
    dig.update(repr((getattr(cfg, "mis", None),
                     getattr(cfg, "mis_power", None),
                     getattr(cfg, "rr_start", None),
                     getattr(cfg, "transport_radiance", None))).encode())
    scene_hash = int.from_bytes(dig.digest()[:6], "little")
    return np.array([cfg.width, cfg.height, cfg.spp, cfg.seed,
                     cfg.max_bounces, scene_hash], np.int64)


def _progressive_loop(scene, cfg, pass_fn, spp_per_pass, checkpoint_path,
                      resume, callback):
    """The pass/accumulate/checkpoint loop of both progressive renders.

    pass_fn(offset, step) -> (H,W,3) film-sum contribution of samples
    [offset, offset + step) of every pixel, in uid-row order, offset a
    (1,) int64 tensor on the scene's device.  The film accumulates on the
    host, in float32."""
    ident = _ckpt_ident(scene, cfg)
    film = np.zeros((cfg.height, cfg.width, 3), np.float32)  # uid-row order
    done = 0
    if checkpoint_path and resume and os.path.exists(checkpoint_path):
        with np.load(checkpoint_path) as z:
            if "ident" not in z or not np.array_equal(z["ident"], ident):
                raise ValueError(
                    f"checkpoint {checkpoint_path} belongs to a different "
                    "render (package/scene/config/seed mismatch); delete it "
                    "or pass resume=False")
            film, done = z["film"], int(z["spp_done"])

    while done < cfg.spp:
        step = min(spp_per_pass, cfg.spp - done)
        offset = torch.full((1,), done, dtype=torch.int64,
                            device=scene.device)
        film = film + pass_fn(offset, step).cpu().numpy()
        done += step
        if checkpoint_path:
            np.savez(checkpoint_path, film=film, spp_done=done, ident=ident)
        if callback:
            callback(done, film[::-1] / max(done, 1))
    return film[::-1] / max(done, 1), done


def render_progressive(scene, cfg: RenderConfig, spp_per_pass=4,
                       checkpoint_path=None, resume=True, callback=None, *,
                       device=None):
    """Accumulate cfg.spp in passes with film checkpoints: the film and
    its sample count persist after each pass (an ``.npz`` with ``film``,
    ``spp_done`` and ``ident``), and a resume adds the remaining samples.

    A pass's path uids are the global ids of the single-shot render (uid
    = pixel * cfg.spp + sample), so the counter-based RNG makes the pass
    split invisible: the film is the mean of the same per-path radiances,
    whatever spp_per_pass or how often the job died.  A checkpoint of
    another render, the JAX package's included, raises ValueError.
    callback(spp_done, image) runs after each pass.  ``device`` as in
    :func:`render`.  Returns (image (H,W,3) float32 numpy, row 0 = top,
    spp_done).
    """
    if device is not None:
        scene = scene.to(device)
    return _progressive_loop(
        scene, cfg,
        lambda off, step: _progressive_pass_jit(scene, off, step, cfg),
        spp_per_pass, checkpoint_path, resume, callback)


def render_bdpt_progressive(scene, cfg: BdptConfig, spp_per_pass=4,
                            checkpoint_path=None, resume=True, callback=None,
                            *, device=None):
    """Progressive BDPT, with the pass/checkpoint/resume contract of
    :func:`render_progressive`.  The t=1 splat film joins the same
    accumulator scaled by 1/n_pix, so the image matches the single-shot
    render_bdpt up to the order of the sums (float tolerance, not bits).
    Returns (image (H,W,3) float32 numpy, row 0 = top, spp_done)."""
    if device is not None:
        scene = scene.to(device)
    return _progressive_loop(
        scene, cfg,
        lambda off, step: _progressive_bdpt_pass_jit(scene, off, step, cfg),
        spp_per_pass, checkpoint_path, resume, callback)


def _loss_l2(img, target):
    return torch.mean((img - target) ** 2)


def _loss_and_grads(render_fn, scene, params, target, cfg):
    """(loss, grads) of the mean squared pixel error of
    ``render_fn(scene with params, cfg)`` against target: a detached 0-d
    tensor and a dict with the keys of ``params``, whose leaf tensors
    require grad."""
    with span("grad.forward"):
        img, _ = render_fn(dataclasses.replace(scene, **params), cfg)
        loss = _loss_l2(img, target)
    with span("grad.backward"):
        grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


def grad_render(scene, params, target, cfg: RenderConfig | None = None,
                **kw):
    """Pixel-loss value and gradients with respect to material and light
    parameter tables.

    params: dict of Scene field overrides to differentiate, e.g.
      {"mat_albedo": ..., "mat_emission": ...}   (BASELINE config 5);
      tensors or arrays, each detached and copied before use.
    target: (H,W,3) target image (row 0 = top).
    Returns (loss, grads): the mean squared pixel error, a 0-d tensor, and
    a dict with the keys of ``params``, both on the scene's device.

    Gradients flow through the shading math only (detached sampling):
    sampled directions and discrete choices are constants.  Keyword
    arguments override ``cfg``, as in :func:`render`.
    """
    from tputracer_torch.integrators.pt import render_pt

    cfg = _with(cfg, RenderConfig, kw)
    dev = scene.device
    p = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
         .detach().clone().requires_grad_() for k, v in params.items()}
    target = torch.as_tensor(target, dtype=torch.float32, device=dev)
    return _loss_and_grads(render_pt, scene, p, target, cfg)
