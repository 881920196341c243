"""Vector math on SoA ``(N, 3)`` float32 tensors.

Port of ``tputracer/geometry.py``: free functions over batched tensors,
no scalar structs.  Dot products sum x, y, z in that order, written out,
so every device and the CUDA kernel round them the same way.
"""

from __future__ import annotations

import math

import torch


def dot(a, b):
    """Batched dot product over the last axis: (N,3),(N,3)->(N,)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def dotk(a, b):
    """Batched dot, keepdims: (N,3),(N,3)->(N,1)."""
    return dot(a, b)[..., None]


def cross(a, b):
    """Cross product over the last axis, component by component."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by,
                        az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def normalize(v, eps=1e-20):
    return v * torch.reciprocal(torch.sqrt(torch.clamp(dotk(v, v), min=eps)))


def onb(n):
    """Branchless orthonormal basis from unit normals (Duff et al., JCGT 2017).

    n: (N,3) unit vectors -> (t, b): two (N,3) tensors, (t, b, n) right-handed.
    """
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    s = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + nz)
    b = nx * ny * a
    t = torch.stack([1.0 + s * nx * nx * a, s * b, -s * nx], dim=-1)
    bt = torch.stack([b, s + ny * ny * a, -ny], dim=-1)
    return t, bt


def to_world(local, n):
    """Map local-frame (N,3) directions (z = normal) to world frame."""
    t, b = onb(n)
    return local[..., 0:1] * t + local[..., 1:2] * b + local[..., 2:3] * n


def face_forward(n, w):
    """Flip n so it lies in the same hemisphere as w."""
    return torch.where(dotk(n, w) < 0.0, -n, n)


def cosine_sample_hemisphere(u1, u2):
    """Cosine-weighted local-frame directions; u1,u2: (N,) -> (N,3), pdf = cos/pi."""
    r = torch.sqrt(u1)
    phi = (2.0 * math.pi) * u2
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    return torch.stack([x, y, z], dim=-1)


def uniform_sample_triangle(u1, u2):
    """Uniform barycentrics on a triangle via the sqrt parameterization."""
    su = torch.sqrt(u1)
    b1 = 1.0 - su
    b2 = u2 * su
    return b1, b2
