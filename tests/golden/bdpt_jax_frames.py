"""JAX's BDPT frames of config 4's caustic box, stored for the card.

The card's test machine has no JAX, so the frames that
tests/test_torch_cuda.py holds the card's BDPT kernel route to (walk,
connect and splat kernels on the card's own intersector) are the JAX
package's ``render_bdpt`` on the CPU, stored in ``bdpt_jax_frames.npz``
beside this file.  tests/test_torch_bdpt.py holds the stored frames to a
fresh JAX render, so the file cannot drift from the reference.

Rewrite the file from the repository root, on the CPU (a few seconds a
frame): ``PYTHONPATH=. python tests/golden/bdpt_jax_frames.py``.
"""

from pathlib import Path

import numpy as np

# the settings of tests/test_torch_bdpt.py's caustic renders: the glass
# sphere refracts in both walks, both MIS heuristics
FRAMES = {
    "caustic": dict(width=16, height=16, spp=4, max_bounces=4, seed=5),
    "caustic_mis_power": dict(width=16, height=16, spp=4, max_bounces=4,
                              seed=11, mis_power=True),
}
STATS = ("rays_closest", "rays_shadow", "splat_energy")
PATH = Path(__file__).with_suffix(".npz")


def jax_frame(name):
    """JAX's render_bdpt of frame ``name``: (image (H, W, 3), stats)."""
    from tputracer.api import render_bdpt
    from tputracer.config import BdptConfig
    from tputracer.scene import cornell_box

    img, st = render_bdpt(cornell_box("caustic"), BdptConfig(**FRAMES[name]))
    return np.asarray(img), {k: float(st[k]) for k in STATS}


def stored(name):
    """Frame ``name`` as the file holds it: (image, stats)."""
    with np.load(PATH) as f:
        return (f[f"{name}.img"],
                {k: float(f[f"{name}.{k}"]) for k in STATS})


def main():
    arrays = {}
    for name in FRAMES:
        img, st = jax_frame(name)
        arrays[f"{name}.img"] = img
        arrays.update({f"{name}.{k}": np.float64(v) for k, v in st.items()})
    np.savez(PATH, **arrays)
    print(f"wrote {PATH}: {', '.join(FRAMES)}")


if __name__ == "__main__":
    main()
