"""tputracer_torch.film: the image writers, against the JAX package's.

The port of tests/unit/test_film.py: PPM and BMP written beside PNG, each
holding to_srgb's bytes, which equal the JAX package's film.to_srgb.
"""

import numpy as np
from PIL import Image

from tputracer.film import to_srgb as jax_to_srgb
from tputracer_torch.film import save_image, to_srgb


def test_ppm_bmp_png_output(tmp_path):
    img = np.random.default_rng(0).uniform(0, 1.2, (8, 6, 3)).astype("f4")
    want = to_srgb(img)
    np.testing.assert_array_equal(want, jax_to_srgb(img))
    np.testing.assert_array_equal(to_srgb(img, exposure=2.0),
                                  jax_to_srgb(img, exposure=2.0))

    raw = open(save_image(img, str(tmp_path / "o.ppm")), "rb").read()
    assert raw.startswith(b"P6\n6 8\n255\n")
    body = raw.split(b"255\n", 1)[1]
    np.testing.assert_array_equal(
        np.frombuffer(body, np.uint8).reshape(8, 6, 3), want)
    for ext in ("bmp", "png"):
        path = save_image(img, str(tmp_path / f"o.{ext}"))
        np.testing.assert_array_equal(np.asarray(Image.open(path)), want)
