"""Progressive rendering with film checkpoints, and the CLI's BDPT path.

Ports of tests/unit/test_progressive.py's four tests on the port (pass-split
accumulation reproduces the single-shot render, for PT and BDPT, and a
resume after a simulated kill reproduces it too), plus: a checkpoint of
another render is refused, the JAX package's included; a PT progressive
render against JAX's at the golden tolerances; the CLI's
``--integrator bdpt``.
"""

import json

import numpy as np
import pytest
import torch

from test_torch_pt import golden_compare
from tputracer.api import render_progressive as jax_render_progressive
from tputracer.config import RenderConfig as JaxRenderConfig
from tputracer.scene import cornell_box as jax_cornell_box
from tputracer_torch import cli
from tputracer_torch.api import (render, render_bdpt, render_bdpt_progressive,
                                 render_progressive)
from tputracer_torch.config import BdptConfig, RenderConfig
from tputracer_torch.scene import cornell_box

CFG = RenderConfig(width=8, height=8, spp=8, max_bounces=2, rr_start=1,
                   seed=4, chunk_size=8 * 8 * 8)
BDPT_CFG = BdptConfig(width=8, height=8, spp=6, max_bounces=2, seed=4,
                      chunk_size=8 * 8 * 6)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)


def die_after_one():
    """A callback that raises KeyboardInterrupt after the first pass."""
    calls = []

    def callback(done, _):
        calls.append(done)
        if len(calls) == 1:
            raise KeyboardInterrupt

    return callback


def test_progressive_matches_single_shot():
    scene = cornell_box("boxes", device="cpu")
    ref, _ = render(scene, CFG)
    img, done = render_progressive(scene, CFG, spp_per_pass=3)
    assert done == CFG.spp
    np.testing.assert_allclose(img, ref.numpy(), rtol=1e-5, atol=1e-7)


def test_progressive_resume_reproduces(tmp_path):
    scene = cornell_box("boxes", device="cpu")
    ck = str(tmp_path / "film.npz")
    with pytest.raises(KeyboardInterrupt):
        render_progressive(scene, CFG, spp_per_pass=2, checkpoint_path=ck,
                           callback=die_after_one())
    with np.load(ck) as z:
        assert int(z["spp_done"]) == 2
    img, done = render_progressive(scene, CFG, spp_per_pass=2,
                                   checkpoint_path=ck)
    ref, _ = render(scene, CFG)
    assert done == CFG.spp
    np.testing.assert_allclose(img, ref.numpy(), rtol=1e-5, atol=1e-7)


def test_progressive_bdpt_matches_single_shot():
    """Pass-split accumulation, the t=1 splat film scaled into the same
    accumulator, reproduces the single-shot render_bdpt."""
    scene = cornell_box("boxes", device="cpu")
    ref, _ = render_bdpt(scene, BDPT_CFG)
    img, done = render_bdpt_progressive(scene, BDPT_CFG, spp_per_pass=4)
    assert done == BDPT_CFG.spp
    np.testing.assert_allclose(img, ref.numpy(), rtol=1e-5, atol=1e-7)


def test_progressive_bdpt_resume_reproduces(tmp_path):
    scene = cornell_box("caustic", device="cpu")
    cfg = BdptConfig(width=8, height=8, spp=4, max_bounces=2, seed=1,
                     chunk_size=8 * 8 * 4)
    ck = str(tmp_path / "bdpt_film.npz")
    with pytest.raises(KeyboardInterrupt):
        render_bdpt_progressive(scene, cfg, spp_per_pass=2,
                                checkpoint_path=ck, callback=die_after_one())
    img, done = render_bdpt_progressive(scene, cfg, spp_per_pass=2,
                                        checkpoint_path=ck)
    ref, _ = render_bdpt(scene, cfg)
    assert done == cfg.spp
    np.testing.assert_allclose(img, ref.numpy(), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("other", ["seed", "integrator", "jax_package"])
def test_mismatched_checkpoint_raises(tmp_path, other):
    """A checkpoint of another render never blends in: another seed, a PT
    film resumed as BDPT with the same five numeric fields, or a film the
    JAX package wrote for the very same scene and config."""
    scene = cornell_box("boxes", device="cpu")
    ck = str(tmp_path / "film.npz")
    cfg = RenderConfig(width=8, height=8, spp=4, max_bounces=2, seed=4,
                       chunk_size=8 * 8 * 4)
    if other == "jax_package":
        jax_render_progressive(jax_cornell_box("boxes"),
                               JaxRenderConfig(**vars(cfg)), spp_per_pass=2,
                               checkpoint_path=ck)
        resume = lambda: render_progressive(scene, cfg, checkpoint_path=ck)
    else:
        render_progressive(scene, cfg, spp_per_pass=2, checkpoint_path=ck,
                           callback=lambda done, _: None)
        if other == "seed":
            resume = lambda: render_progressive(
                scene, cfg.with_(seed=5), checkpoint_path=ck)
        else:
            resume = lambda: render_bdpt_progressive(
                scene, BdptConfig(width=8, height=8, spp=4, max_bounces=2,
                                  seed=4), checkpoint_path=ck)
    with pytest.raises(ValueError, match="different render"):
        resume()
    # resume=False starts over and overwrites the stale film
    img, done = render_progressive(scene, cfg, checkpoint_path=ck,
                                   resume=False)
    assert done == cfg.spp and np.isfinite(img).all()


def test_progressive_matches_jax():
    """A PT progressive render against tputracer's render_progressive on
    the same config and passes, at the golden tolerances."""
    kw = dict(width=16, height=16, spp=4, max_bounces=4, rr_start=2, seed=6,
              chunk_size=16 * 16 * 4)
    img_j, done_j = jax_render_progressive(jax_cornell_box("boxes"),
                                           JaxRenderConfig(**kw),
                                           spp_per_pass=2)
    img_t, done_t = render_progressive(cornell_box("boxes", device="cpu"),
                                       RenderConfig(**kw), spp_per_pass=2)
    assert done_t == done_j == 4
    golden_compare(img_t, np.asarray(img_j))


def test_cli_renders_bdpt(tmp_path, capsys):
    out = tmp_path / "bdpt.png"
    cli.main(["--integrator", "bdpt", "--device", "cpu", "--size", "8",
              "--spp", "2", "--bounces", "2", "--exposure", "2",
              "--out", str(out)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["integrator"] == "bdpt" and line["out"] == str(out)
    assert {"scene", "size", "spp", "bounces", "compile_s", "render_s",
            "rays_per_s", "mean"} <= set(line)
    assert out.exists() and line["mean"] > 0.0
