"""Public API: ``render`` (wavefront path tracer)."""

from __future__ import annotations

from tputracer_torch.config import RenderConfig


def render(scene, cfg: RenderConfig | None = None, *, device=None, **kw):
    """Render with the wavefront path tracer. Returns (image, stats).

    image is an (H,W,3) float32 tensor (row 0 = top) and stats a dict of
    per-bounce ray counts, both on the render's device.  ``device`` moves
    the scene there first (None keeps the scene's own device); keyword
    arguments override fields of ``cfg``.
    """
    from tputracer_torch.integrators.pt import render_pt

    cfg = (cfg or RenderConfig()).with_(**kw) if kw or cfg is None else cfg
    if device is not None:
        scene = scene.to(device)
    return render_pt(scene, cfg)
