"""Counter-based sampler: pcg3d of (path uid, salt, seed).

Port of ``tputracer/rng.py``.  Every sample is a pure function of the
path's global uid, a salt (bounce * SALT_STRIDE + slot) and the frame
seed, so the stream does not depend on chunking or device, and the two
packages draw bitwise the same numbers (Jarzynski & Olano, JCGT 2020).

PyTorch has little uint32 arithmetic, so the hash runs in int32: sums and
products wrap to the same low 32 bits as uint32 would, and every right
shift is made logical by masking off the sign-extended bits.
"""

from __future__ import annotations

import torch

# Dimension-group slots within one bounce (same values as tputracer.rng).
SALT_STRIDE = 8
SLOT_LIGHT = 0      # light pick + light-surface (u,v)
SLOT_BSDF = 1       # lobe pick + direction (u,v)
SLOT_RR = 2         # russian roulette
SLOT_CAMERA = 3     # pixel jitter (bounce 0 only)
SLOT_LIGHT_ORIGIN = 4
SLOT_LIGHT_DIR = 5
SLOT_LBSDF = 6

_INV_2_24 = 1.0 / 16777216.0


def _as_i32(v: int) -> int:
    """A Python int taken mod 2^32, as the signed int32 with those bits."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def _lshr16(x):
    return (x >> 16) & 0xFFFF


def _pcg3d(x, y, z):
    """pcg3d on int32 tensors holding uint32 bit patterns."""
    m = 1664525
    a = 1013904223
    x = x * m + a
    y = y * m + a
    z = z * m + a
    x = x + y * z
    y = y + z * x
    z = z + x * y
    x = x ^ _lshr16(x)
    y = y ^ _lshr16(y)
    z = z ^ _lshr16(z)
    x = x + y * z
    y = y + z * x
    z = z + x * y
    return x, y, z


def _to_unit(bits):
    # top 24 bits -> [0, 1), exactly representable in float32
    return ((bits >> 8) & 0xFFFFFF).to(torch.float32) * _INV_2_24


def uniform3(uid, salt, seed):
    """Three U[0,1) streams for each path.

    uid:  (N,) integer tensor of path ids; taken mod 2^32 like the JAX
          package's uint32 ids
    salt: int — bounce * SALT_STRIDE + slot
    seed: int — frame seed
    returns three (N,) float32 tensors
    """
    u = uid.to(torch.int64) & 0xFFFFFFFF
    u = torch.where(u >= (1 << 31), u - (1 << 32), u).to(torch.int32)
    s = torch.full_like(u, _as_i32(int(salt)))
    sd = torch.full_like(u, _as_i32(int(seed)))
    x, y, z = _pcg3d(u, s, sd)
    return _to_unit(x), _to_unit(y), _to_unit(z)


def salt(bounce: int, slot: int) -> int:
    return int(bounce) * SALT_STRIDE + int(slot)
