"""tputracer_torch.rng: bitwise equal to tputracer.rng's NumPy twin.

The port's pcg3d runs in int32 (wrapping sums and products, logical right
shifts by masking); the JAX package's in uint32.  Both must give the very
same float32 streams, or no image of the two packages could match.
"""

import numpy as np
import pytest
import torch

from tputracer import rng as jrng
from tputracer_torch import rng as trng


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


def test_uid_wraps_mod_2_32():
    """A uid and uid + 2^32 are the same uint32 id."""
    uid = torch.arange(0, 1000, dtype=torch.int64) * 977
    a = trng.uniform3(uid, 5, 11)
    b = trng.uniform3(uid + 2**32, 5, 11)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_salt_and_slots_match():
    names = ["SALT_STRIDE", "SLOT_LIGHT", "SLOT_BSDF", "SLOT_RR",
             "SLOT_CAMERA", "SLOT_LIGHT_ORIGIN", "SLOT_LIGHT_DIR",
             "SLOT_LBSDF"]
    for name in names:
        assert getattr(trng, name) == getattr(jrng, name), name
    assert trng.salt(4, trng.SLOT_RR) == jrng.salt(4, jrng.SLOT_RR)
