"""Film / image output (SURVEY.md §2 row 12: Camera & film).

The reference accumulates into a CPU film buffer and writes BMP.  Here the
film is just the (H,W,3) mean over the spp axis computed on-device (see
integrators.pt.render_pt); this module handles host-side tonemapping and
PNG output via Pillow.
"""

from __future__ import annotations

import numpy as np


def to_srgb(img, exposure=1.0):
    """Linear HDR -> clamped sRGB uint8."""
    x = np.asarray(img, np.float32) * exposure
    x = np.clip(x, 0.0, 1.0)
    srgb = np.where(x <= 0.0031308, 12.92 * x, 1.055 * x ** (1.0 / 2.4) - 0.055)
    return (srgb * 255.0 + 0.5).astype(np.uint8)


def save_png(img, path, exposure=1.0):
    from PIL import Image

    Image.fromarray(to_srgb(img, exposure)).save(path)
    return path


def save_ppm(img, path, exposure=1.0):
    """Binary PPM (P6) writer — the reference-class renderers emit
    BMP/PPM; provided so a reference user keeps their toolchain."""
    data = to_srgb(img, exposure)
    h, w, _ = data.shape
    with open(path, "wb") as fh:
        fh.write(f"P6\n{w} {h}\n255\n".encode())
        fh.write(data.tobytes())
    return path


def save_image(img, path, exposure=1.0):
    """Dispatch on extension: .ppm -> PPM, anything else via Pillow
    (png/bmp/jpg...)."""
    if str(path).lower().endswith(".ppm"):
        return save_ppm(img, path, exposure)
    from PIL import Image

    Image.fromarray(to_srgb(img, exposure)).save(path)
    return path
