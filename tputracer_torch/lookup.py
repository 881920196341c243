"""Small-table lookups, port of ``tputracer/lookup.py``.

Every per-lane lookup into a small SoA table (materials, emitters,
spheres, the normals and materials of an unclustered scene's triangles)
goes through here, at the JAX package's own call sites.  The JAX package
writes a lookup as the dense product ``one_hot(idx, M) @ table``, which
the TPU runs far faster than a gather, and JAX derives its gradient as
``one_hot(idx, M)^T @ g``: a dense contraction whose summation order does
not depend on the ids.

Here the forward is a gather, which gives the same bits (below).  The
gradient keeps the JAX form: :func:`fetch` backpropagates through a
blocked one-hot matmul in float32, not through ``table[idx]``'s own
backward (``IndexBackward0``, a sort-based accumulate that costs
milliseconds a call on the card at 2^16 lanes into a 6-row table).

Contract on the ids: every id lies in ``[0, M)``.  JAX's one-hot reads
zeros outside it; ``table[idx]`` raises for an id of ``M`` or more and
wraps a negative one to the end of the table.  The callers never pass
one: ``finalize_hit`` clamps the misses' ``prim = -1`` to row 0, and
``sample_light`` clamps the emitter pick to ``E - 1``.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

_THRESHOLD = 2048
# elements of one block of the one-hot in the backward (64 MiB of float32)
_BLOCK_ELEMS = 1 << 24


def fetch(table, idx, threshold=_THRESHOLD):
    """table (M,) or (M, K) indexed by idx (N,) int -> (N,) / (N, K).

    Forward: the gather ``table[idx]``.  For ids in ``[0, M)`` and a
    finite table it has the bits of JAX's ``one_hot(idx, M) @ table`` at
    HIGHEST precision, whose every output is one table entry times 1 plus
    zeros (a -0.0 entry aside, which the product may return as +0.0).

    Backward, where ``M <= threshold``, the table has at most 2 dims and
    it needs a gradient: JAX's VJP ``one_hot(idx, M)^T @ g`` as a float32
    ``torch.matmul``, the lanes taken in blocks of a fixed size (the
    largest power of two with block x M <= 2^24) and the blocks' (M, K)
    partial sums added in order, so that the summation order depends on
    N and M only, never on the ids.  TF32 (or bf16 on the CPU) would round
    the gradient, and the switches that allow it are process-global: the
    backward refuses with a RuntimeError while they allow it for float32
    matmuls on the gradient's device, rather than return a result that
    depends on them.  Elsewhere ``fetch`` is ``table[idx]`` as it stands,
    so renders keep their bits and their kernels.
    """
    m = table.shape[0]
    if (m > threshold or table.dim() > 2
            or not (torch.is_grad_enabled() and table.requires_grad)):
        return table[idx.long()]
    return _OneHotFetch.apply(table, idx.long())


def fetch_int(table, idx, threshold=_THRESHOLD):
    """Integer-table lookup: the gather ``table[idx]``, exact for every
    value on either side of ``threshold`` (JAX's is exact for |values| <
    2^24, the float32 mantissa its one-hot product passes them through)."""
    return table[idx.long()]


class _OneHotFetch(torch.autograd.Function):
    """``table[idx]`` whose backward is ``one_hot(idx, M)^T @ g``."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.m = table.shape[0]
        return table[idx]

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        return one_hot_vjp(idx, g, ctx.m), None


def _fp32_matmul_lowered(device_type):
    """Whether float32 matmuls on this device type may run in TF32 or bf16
    (``torch.backends.*.fp32_precision``, which the older switches
    ``allow_tf32`` and ``set_float32_matmul_precision`` also set)."""
    backend = (torch.backends.cuda.matmul if device_type == "cuda"
               else torch.backends.mkldnn.matmul)
    precision = backend.fp32_precision
    if precision == "none":           # inherits the generic setting
        precision = torch.backends.fp32_precision
    return precision not in ("none", "ieee")


def one_hot_vjp(idx, g, m):
    """``one_hot(idx, m)^T @ g`` for idx (N,) in [0, m) and g (N,) or
    (N, K) float32: (m,) or (m, K), in blocks of lanes (see :func:`fetch`).
    An id outside [0, m) adds nothing, as in JAX's one-hot."""
    if _fp32_matmul_lowered(g.device.type):
        raise RuntimeError(
            "lookup.fetch's backward runs its one-hot matmul in full float32, "
            f"but float32 matmuls on {g.device.type} may use TF32 or bf16 "
            "(torch.backends.fp32_precision, torch.backends.{cuda,mkldnn}."
            "matmul.fp32_precision, allow_tf32 or "
            "torch.set_float32_matmul_precision): set them back to 'ieee' "
            "or 'highest' to take this gradient")
    n = idx.shape[0]
    g2 = g.reshape(n, -1)
    block = 1 << ((_BLOCK_ELEMS // m).bit_length() - 1)
    rows = torch.arange(m, device=idx.device)
    out = torch.zeros((m, g2.shape[1]), dtype=g.dtype, device=g.device)
    for s in range(0, n, block):
        one_hot_t = (rows[:, None] == idx[None, s:s + block]).to(g.dtype)
        out += torch.matmul(one_hot_t, g2[s:s + block])
    return out.reshape((m,) + tuple(g.shape[1:]))
