"""tputracer_torch.dist.launch: worlds of real processes on the CPU (gloo),
port of tests/distributed/test_multiprocess.py.

Two ranks render and print the same image mean; the kill drill loses rank
1 mid-fit and a fresh world resumes from rank 0's checkpoint; the sharded
BDPT fit step crosses the process boundary forward and backward.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import torch_dist_worker as W
from tputracer import dist as jdist
from tputracer.api import render as jax_render
from tputracer.config import BdptConfig as JaxBdptConfig
from tputracer.config import RenderConfig as JaxRenderConfig
from tputracer.scene import cornell_box as jax_cornell_box
from tputracer_torch.dist import launch


def _ok(outs):
    for rc, _, err in outs:
        assert rc == 0, err[-3000:]
    return [W.parse(out) for _, out, _ in outs]


def test_two_ranks_render_the_jax_image(tmp_path):
    """Both ranks print the same image mean, JAX's in-process render's
    at rtol 1e-6."""
    recs = _ok(W.run_world("render", 2, str(tmp_path)))
    means = [r["mean"] for rs in recs for r in rs if r["mode"] == "render"]
    assert len(means) == 2 and means[0] == means[1]
    ref = float(np.asarray(jax_render(jax_cornell_box("boxes"),
                                      JaxRenderConfig(**W.PT))[0]).mean())
    np.testing.assert_allclose(means[0], ref, rtol=1e-6)


def _losses(recs):
    return {r["step"]: r["loss"] for r in recs if r["mode"] == "fit"}


def test_kill_drill_resumes_bit_for_bit(tmp_path):
    """Rank 1 dies (exit code 42) after step 3 of a 6-step fit(mesh=);
    the survivor fails at its next collective or is killed when its time
    is up; a fresh world of two resumes from rank 0's checkpoint at step
    3.  gloo sums two ranks in a fixed order, so the
    resumed losses and the final albedo are the uninterrupted run's bit
    for bit."""
    steps = 6
    recs = _ok(W.run_world("fit", 2, str(tmp_path / "ref"), steps=steps))
    ref = _losses(recs[0])
    assert sorted(ref) == list(range(steps))
    assert _losses(recs[1]) == ref
    ref_albedo = W.load(str(tmp_path / "ref"), 0)["albedo"]

    ck = str(tmp_path / "fit.npz")
    crash = str(tmp_path / "crash")
    os.makedirs(crash)
    init = f"file://{crash}/rendezvous"
    procs = [W.start_rank("fit", 2, r, init, crash, steps=steps, crash_at=3,
                          checkpoint=ck) for r in range(2)]
    outs = W.wait_all(procs, timeout=120)
    assert outs[1][0] == 42, outs[1][2][-3000:]
    assert outs[0][0] != 0
    assert os.path.exists(ck)

    recs = _ok(W.run_world("fit", 2, str(tmp_path / "resume"), steps=steps,
                           checkpoint=ck))
    resumed = _losses(recs[0])
    assert min(resumed) == 3 and sorted(resumed) == [3, 4, 5]
    assert resumed == {s: ref[s] for s in resumed}
    np.testing.assert_array_equal(
        W.load(str(tmp_path / "resume"), 0)["albedo"], ref_albedo)


def test_bdpt_fit_across_processes_matches_jax(tmp_path):
    """fit_step_bdpt_sharded on two processes, toward JAX's 8-device
    render_bdpt_sharded: both ranks' loss and gradient sum are equal, and
    JAX's 8-device step's at rtol 1e-6 and 1e-5.  The splat's all-reduce
    crosses the processes in the forward and the backward pass."""
    scene = jax_cornell_box("boxes")
    cfg = JaxBdptConfig(**W.BDPT)
    mesh = jdist.make_mesh((8,), ("dp",))
    target = jdist.render_bdpt_sharded(scene, cfg, mesh)
    tgt = str(tmp_path / "target.npy")
    np.save(tgt, np.asarray(target))
    recs = _ok(W.run_world("bdpt_fit", 2, str(tmp_path), target=tgt))
    got = [r for rs in recs for r in rs if r["mode"] == "bdpt_fit"]
    assert len(got) == 2
    assert got[0]["loss"] == got[1]["loss"]
    assert got[0]["grad_sum"] == got[1]["grad_sum"]
    params = {"mat_albedo": scene.mat_albedo * 0.6}
    loss, grads = jdist.fit_step_bdpt_sharded(scene.replace(**params), params,
                                              target, cfg, mesh)
    np.testing.assert_allclose(got[0]["loss"], float(loss), rtol=1e-6)
    np.testing.assert_allclose(got[0]["grad_sum"],
                               float(sum(jnp.sum(g) for g in grads.values())),
                               rtol=1e-5)


def test_initialize_names_its_backend(tmp_path):
    """No backend is picked silently: None raises; NCCL without a card
    raises before it joins; gloo forms a world of one, whose
    replicate_global gives back the scene's tensors."""
    init = f"file://{tmp_path}/world"
    with pytest.raises(ValueError, match="backend"):
        launch.initialize(init, 1, 0)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="CUDA"):
            launch.initialize(init, 1, 0, backend="nccl")
    from tputracer_torch.dist import make_mesh
    from tputracer_torch.scene import cornell_box

    launch.initialize(init, 1, 0, backend="gloo")
    try:
        scene = cornell_box("boxes", device="cpu")
        rep = launch.replicate_global(scene, make_mesh())
        assert torch.equal(rep.plu, scene.plu) and rep.plu is not scene.plu
        assert torch.equal(rep.camera.o, scene.camera.o)
        assert rep.n_tris == scene.n_tris
    finally:
        launch.shutdown()
