"""tputracer_torch.dist.bdpt_ring: ring-connection BDPT over a gloo world of
processes on the CPU, against its single-process emulation, the JAX
package's emulation and plain BDPT.

One world of 4 ranks (tests/torch_dist_worker.py, mode "ring") renders at
P = 4 and on the (2, 2) mesh.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import torch_dist_worker as W
from tputracer.config import BdptConfig as JaxBdptConfig
from tputracer.dist.bdpt_ring import emulate_ring_bdpt as jax_emulate
from tputracer.scene import cornell_box as jax_cornell_box
from tputracer_torch.api import render_bdpt
from tputracer_torch.config import BdptConfig
from tputracer_torch.dist.bdpt_ring import emulate_ring_bdpt
from tputracer_torch.integrators.pt import film_from_radiance
from tputracer_torch.scene import cornell_box


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ring"))
    for rc, _, err in W.run_world("ring", 4, out):
        assert rc == 0, err[-3000:]
    return [W.load(out, r) for r in range(4)]


def caustic():
    return cornell_box("caustic", device="cpu")


def emulated_image(cfg, P):
    """The P-shard ring estimator in one process, as a film."""
    n = cfg.width * cfg.height * cfg.spp
    L, splat = emulate_ring_bdpt(caustic(), torch.arange(n), cfg, P)
    splat = torch.flip((splat / float(n)).reshape(cfg.height, cfg.width, 3),
                       dims=(0,))
    return (film_from_radiance(L, cfg) + splat).numpy()


@pytest.mark.parametrize("P", [1, 4])
def test_emulation_matches_jax(P):
    """emulate_ring_bdpt against JAX's: per-path radiance and splat film
    at the golden tolerances (the same pairings, float noise apart)."""
    cfg = BdptConfig(**W.BDPT3)
    n = cfg.width * cfg.height * cfg.spp
    L, splat = emulate_ring_bdpt(caustic(), torch.arange(n), cfg, P)
    L_j, splat_j = jax_emulate(jax_cornell_box("caustic"),
                               jnp.arange(n, dtype=jnp.uint32),
                               JaxBdptConfig(**W.BDPT3), P)
    for mine, ref in ((L.numpy(), np.asarray(L_j)),
                      (splat.numpy(), np.asarray(splat_j))):
        rel = np.abs(mine - ref) / (1.0 + np.abs(ref))
        assert float(rel.mean()) < 5e-4 and float((rel > 5e-3).mean()) < 0.01
    assert float(L.abs().sum()) > 0.0


@pytest.mark.parametrize("mesh", ["p4", "p22"])
def test_ring_matches_emulation(ranks, mesh):
    """render_bdpt_ring at P = 4, on a (4,) and a (2, 2) mesh, against the
    single-process emulation (rtol 2e-5, JAX's ring test); every rank
    holds the same image."""
    ref = emulated_image(BdptConfig(**W.BDPT3), 4)
    np.testing.assert_allclose(ranks[0][f"{mesh}_img"], ref, rtol=2e-5,
                               atol=1e-6)
    for r in range(1, 4):
        np.testing.assert_array_equal(ranks[r][f"{mesh}_img"],
                                      ranks[0][f"{mesh}_img"])


def test_emulation_of_one_shard_is_plain_bdpt():
    """One shard joins each eye path to its own light path only: plain
    BDPT (up to the order of the splat's sums)."""
    cfg = BdptConfig(**W.BDPT3)
    ref, _ = render_bdpt(caustic(), cfg)
    np.testing.assert_allclose(emulated_image(cfg, 1), ref.numpy(),
                               rtol=1e-5, atol=1e-7)


def test_ring_converges_to_plain_bdpt():
    """P partners a connection estimate the same integrals as plain BDPT:
    at 8 spp the image means agree within 5% (JAX's ring test)."""
    cfg = BdptConfig(**dict(W.BDPT3, spp=8, chunk_size=16 * 16 * 8))
    a = float(emulated_image(cfg, 4).mean())
    b = float(render_bdpt(caustic(), cfg)[0].mean())
    assert abs(a - b) / b < 0.05, (a, b)
