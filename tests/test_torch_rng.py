"""tputracer_torch.rng: bitwise equal to tputracer.rng's NumPy twin.

The port's pcg3d runs in int32 (wrapping sums and products, logical right
shifts by masking); the JAX package's in uint32.  Both must give the very
same float32 streams, or no image of the two packages could match.  On
CPU tensors uniform3 takes the torch version, uniform3_plain; the CUDA
kernel (csrc/rng.cu) is held to it on the card in test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from tputracer import rng as jrng
from tputracer_torch import rng as trng
from tputracer_torch import cuda_build, trace


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)


@pytest.mark.parametrize("salt, seed", [
    (0, 0),
    (jrng.salt(3, jrng.SLOT_BSDF), 7),
    (jrng.salt(0, jrng.SLOT_CAMERA), 2**31 + 5),
    (2**32 - 1, 4_000_000_000),
    (123_456_789, 2**32 - 1),
])
def test_uniform3_bitwise_equal(salt, seed):
    r = np.random.default_rng(salt % 1000 + seed % 1000)
    uid = np.concatenate([
        r.integers(0, 2**32, size=20_000, dtype=np.uint64),   # incl. >= 2^31
        np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.uint64),
    ])
    want = jrng.uniform3_np(uid.astype(np.uint32), salt, seed)
    got = trng.uniform3(torch.from_numpy(uid.astype(np.int64)), salt, seed)
    for w, g in zip(want, got):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("step, salt, seed", [(977, 5, 11),
                                               (-4_099, 9, 2**31)],
                         ids=["non-negative", "negative"])
def test_uid_wraps_mod_2_32(step, salt, seed):
    """A uid and uid + 2^32 are the same uint32 id; a negative int64 uid
    is its low 32 bits."""
    uid = torch.arange(0, 1000, dtype=torch.int64) * step
    a = trng.uniform3(uid, salt, seed)
    b = trng.uniform3(uid + 2**32, salt, seed)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_salt_and_slots_match():
    names = ["SALT_STRIDE", "SLOT_LIGHT", "SLOT_BSDF", "SLOT_RR",
             "SLOT_CAMERA", "SLOT_LIGHT_ORIGIN", "SLOT_LIGHT_DIR",
             "SLOT_LBSDF"]
    for name in names:
        assert getattr(trng, name) == getattr(jrng, name), name
    assert trng.salt(4, trng.SLOT_RR) == jrng.salt(4, jrng.SLOT_RR)


def test_cpu_uids_take_the_torch_route(monkeypatch):
    """A CPU uid goes to uniform3_plain, never to the kernel's wrapper,
    and its span counts kernel 0."""
    def no_kernel(*args):
        raise AssertionError("the CUDA route was taken for a CPU tensor")

    monkeypatch.setattr(trng, "uniform3_cuda", no_kernel)
    trace.reset()
    uid = torch.arange(-500, 500, dtype=torch.int64) * 8_589_935
    launches = cuda_build.LAUNCHES["uniform3_kernel"]
    got = trng.uniform3(uid, 2**31 + 3, 2**32 - 7)
    want = trng.uniform3_plain(uid, 2**31 + 3, 2**32 - 7)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    (rec,) = trace.records("rng.uniform3")
    assert rec.counts == {"kernel": 0}
    assert cuda_build.LAUNCHES["uniform3_kernel"] == launches


def test_uniform3_refuses_a_device_without_a_route():
    with pytest.raises(ValueError, match="no sampler route"):
        trng.uniform3(torch.zeros(4, dtype=torch.int64, device="meta"), 0, 0)


def test_uniform3_cuda_refuses_a_cpu_uid():
    """The kernel's wrapper takes CUDA tensors only; its dtype, shape and
    contiguity checks are held on the card."""
    with pytest.raises(ValueError, match="uniform3_cuda"):
        trng.uniform3_cuda(torch.arange(8, dtype=torch.int64), 0, 0)
