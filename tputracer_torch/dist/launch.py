"""Joining a world of processes, port of ``tputracer/dist/launch.py``.

The JAX package forms one multi-controller cluster with
``jax.distributed.initialize``; here every process is one rank of a
``torch.distributed`` process group, and the entry points of
``tputracer_torch.dist`` run the same program on every rank.

The backend is the caller's choice, never picked here:

  * ``"nccl"`` when every rank has a card of its own (NCCL refuses two
    ranks of one communicator on one device, and :func:`initialize` says
    so before NCCL does);
  * ``"gloo"`` on the CPU, and for ranks that share one card.  Under gloo
    the collectives of ``dist.mesh`` and the ring's hops stage CUDA
    tensors through host memory explicitly; the compute stays on the card.
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def initialize(init_method, world_size, rank, backend=None, timeout_s=600):
    """Join (or form) a world of ``world_size`` ranks as ``rank``.

    init_method: a ``torch.distributed`` init method, e.g.
    ``"tcp://localhost:29500"``, ``"file:///path/to/shared/file"`` or
    ``"env://"`` (torchrun's environment).  backend: ``"nccl"`` or
    ``"gloo"``; None raises, since nothing here picks one.  With NCCL the
    rank uses ``torch.cuda.current_device()`` (set it first), and two
    ranks on one device raise ValueError.  timeout_s bounds every
    collective: a rank whose peer died fails after it instead of waiting
    forever.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}:"
                         " 'nccl' with a card a rank, 'gloo' on the CPU or "
                         "for ranks that share a card")
    if backend == "nccl" and not torch.cuda.is_available():
        raise ValueError("backend 'nccl' needs a CUDA card on every rank")
    # no device_id: NCCL then makes its communicator at the first
    # collective, after the shared-card check below
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    if backend == "nccl":
        _refuse_shared_card(torch.cuda.current_device(), world_size, rank)


def _refuse_shared_card(device, world_size, rank):
    """Raise if another rank of the world uses this rank's card: NCCL
    refuses that when it first communicates, with a less plain message.
    The cards' UUIDs cross through the process group's store, not through
    NCCL."""
    store = dist.distributed_c10d._get_default_store()
    store.set(f"tputracer_card_{rank}",
              str(torch.cuda.get_device_properties(device).uuid))
    cards = [store.get(f"tputracer_card_{r}").decode()
             for r in range(world_size)]
    shared = [r for r in range(world_size)
              if r != rank and cards[r] == cards[rank]]
    if shared:
        dist.destroy_process_group()
        raise ValueError(
            f"NCCL needs a card a rank, but ranks {sorted([rank] + shared)} "
            "share one; ranks that share a card use backend='gloo'")


def shutdown():
    """Leave the world (a no-op outside one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def replicate_global(tree, mesh):
    """Rank 0's copy of a Scene or a dict of tensors, on every rank.

    Each tensor is broadcast from the mesh's first rank into a copy, on
    the tensor's own device; a Scene keeps its static fields.  Use it
    where the ranks' copies may differ (a scene read from a file on one
    host); scenes built by the deterministic builders are equal already.
    """
    import dataclasses

    from tputracer_torch.dist.mesh import broadcast
    from tputracer_torch.scene.types import Camera, Scene

    if isinstance(tree, (Scene, Camera)):
        kw = {f.name: replicate_global(getattr(tree, f.name), mesh)
              for f in dataclasses.fields(tree)
              if isinstance(getattr(tree, f.name), (torch.Tensor, Camera))}
        return dataclasses.replace(tree, **kw)
    if isinstance(tree, dict):
        return {k: replicate_global(v, mesh) for k, v in tree.items()}
    return broadcast(tree, mesh)
