"""Public API: ``render`` (wavefront path tracer), ``render_bdpt``
(bidirectional path tracer) and their progressive forms with film
checkpoints, ``render_progressive`` and ``render_bdpt_progressive``."""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from tputracer_torch.config import BdptConfig, RenderConfig


def _with(cfg, default, kw):
    return (cfg or default()).with_(**kw) if kw or cfg is None else cfg


def render(scene, cfg: RenderConfig | None = None, *, device=None, **kw):
    """Render with the wavefront path tracer. Returns (image, stats).

    image is an (H,W,3) float32 tensor (row 0 = top) and stats a dict of
    per-bounce ray counts, both on the render's device.  ``device`` moves
    the scene there first (None keeps the scene's own device); keyword
    arguments override fields of ``cfg``.
    """
    from tputracer_torch.integrators.pt import render_pt

    cfg = _with(cfg, RenderConfig, kw)
    if device is not None:
        scene = scene.to(device)
    return render_pt(scene, cfg)


def render_bdpt(scene, cfg: BdptConfig | None = None, *, device=None, **kw):
    """Render with the bidirectional path tracer. Returns (image, stats).

    image is an (H,W,3) float32 tensor (row 0 = top); stats holds the
    closest-hit and shadow rays traced and the t=1 splat film's energy,
    as tensors on the render's device.  ``device`` and keyword arguments
    as in :func:`render`.
    """
    from tputracer_torch.integrators.bdpt import render_bdpt as _rb

    cfg = _with(cfg, BdptConfig, kw)
    if device is not None:
        scene = scene.to(device)
    return _rb(scene, cfg)


def _pass_uids(cfg, offset, step, device):
    """The uids of samples [offset, offset + step) of every pixel, pixel by
    pixel: the global ids the single-shot render gives those samples."""
    pix = torch.arange(cfg.width * cfg.height, dtype=torch.int64,
                       device=device)[:, None]
    return (pix * cfg.spp + offset
            + torch.arange(step, dtype=torch.int64, device=device)[None, :]
            ).reshape(-1)


def _pt_pass(scene, cfg, offset, step):
    """Film-sum contribution (H,W,3) of one path-tracing pass, uid rows."""
    from tputracer_torch.integrators.pt import trace_chunked

    L, _ = trace_chunked(scene, _pass_uids(cfg, offset, step, scene.device),
                         cfg)
    return L.reshape(cfg.height, cfg.width, step, 3).sum(dim=2)


def _bdpt_pass(scene, cfg, offset, step):
    """Film-sum contribution (H,W,3) of one BDPT pass, uid rows."""
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
    [offset, offset + step) of every pixel, in uid-row order.  The film
    accumulates on the host, in float32."""
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
        film = film + pass_fn(done, step).cpu().numpy()
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
        scene, cfg, lambda off, step: _pt_pass(scene, cfg, off, step),
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
        scene, cfg, lambda off, step: _bdpt_pass(scene, cfg, off, step),
        spp_per_pass, checkpoint_path, resume, callback)
