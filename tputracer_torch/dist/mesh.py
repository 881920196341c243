"""Rays data-parallel over a world of ranks, port of ``tputracer/dist/mesh.py``.

  * **DP over rays**: rank r traces the paths of image rows
    [r * rows_per, (r + 1) * rows_per) in uid order (bottom-up).  Path
    uids are global and the RNG is keyed by uid, and the intersection
    kernels give every ray the same bits whatever else is in its batch,
    so :func:`render_sharded` gives the bits of ``api.render`` on the same
    device, whatever the world's size or the mesh's shape.
  * **Scene replicated**: every rank holds the whole scene
    (``dist.scene_shard`` tiles it instead).
  * **Gradients all-reduced**: a fit step's loss and gradients are summed
    over the world in one all-reduce of one flat buffer, in a fixed order.

A :class:`Mesh` names a process group and a shape.  As in the JAX package,
rays shard over all axes jointly and collectives reduce over the whole
world, with the shard index the rank in row-major axis order, so ``(2, 2)``
and ``(4,)`` compute the same thing.

Collectives run on the backend the world was formed with
(``dist.launch``).  Under gloo a CUDA tensor is copied to the host, sent,
and copied back, explicitly; NCCL takes it where it lies.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from tputracer_torch.integrators.pt import film_from_radiance, trace_chunked


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A world (or a process group) seen as a grid of ranks."""

    shape: tuple
    axis_names: tuple
    rank: int          # this rank's shard index: its rank in ``group``
    size: int
    backend: str
    group: object = None   # a ProcessGroup; None is the default world

    def peer(self, i):
        """The global rank of shard ``i``."""
        return i if self.group is None else dist.get_global_rank(self.group, i)


def make_mesh(shape=None, axis_names=None, group=None):
    """The mesh over the ranks of ``group`` (default: the world).

    shape: axis sizes whose product is the group's size (default: one
    "dp" axis); axis_names default to ("dp",) or ("host", "chip")."""
    size = dist.get_world_size(group)
    shape = (size,) if shape is None else tuple(int(s) for s in shape)
    if math.prod(shape) != size:
        raise ValueError(f"mesh shape {shape} does not hold {size} ranks")
    if axis_names is None:
        axis_names = ("dp",) if len(shape) == 1 else ("host", "chip")[
            : len(shape)]
    return Mesh(shape, tuple(axis_names), dist.get_rank(group), size,
                str(dist.get_backend(group)), group)


# ---- collectives -----------------------------------------------------------

def _staged(x, mesh):
    """The tensor a collective sends: a host copy of a CUDA tensor under
    gloo, else a copy where it lies (a collective writes into it)."""
    x = x.detach()
    if mesh.backend == "gloo" and x.is_cuda:
        return x.cpu().contiguous()
    return x.clone(memory_format=torch.contiguous_format)


def all_reduce_sum(x, mesh):
    """The sum of ``x`` over the mesh, on ``x``'s device (a new tensor)."""
    buf = _staged(x, mesh)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    return buf.to(x.device)


def all_gather_rows(x, mesh):
    """Every shard's ``x``, concatenated along dim 0 in shard order."""
    buf = _staged(x, mesh)
    out = [torch.empty_like(buf) for _ in range(mesh.size)]
    dist.all_gather(out, buf, group=mesh.group)
    return torch.cat(out, dim=0).to(x.device)


def broadcast(x, mesh):
    """Shard 0's ``x`` on every shard (a new tensor on ``x``'s device)."""
    buf = _staged(x, mesh)
    dist.broadcast(buf, src=mesh.peer(0), group=mesh.group)
    return buf.to(x.device)


def ring_shift(x, mesh):
    """One hop of the ring: send ``x`` to shard rank + 1 and return what
    shard rank - 1 sent, on ``x``'s device.  One ``batch_isend_irecv`` of
    one buffer; the caller packs its state into it."""
    if mesh.size == 1:
        return x
    buf = _staged(x, mesh)
    out = torch.empty_like(buf)
    r, P = mesh.rank, mesh.size
    ops = [dist.P2POp(dist.isend, buf, mesh.peer((r + 1) % P), mesh.group),
           dist.P2POp(dist.irecv, out, mesh.peer((r - 1) % P), mesh.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.to(x.device)


def pack(tensors):
    """Tensors of equal leading size n (float32, int32 or bool) as one
    (n, words) int32 buffer: floats bit-cast, bools as 0/1.  Ints never
    pass through float arithmetic, and NCCL, which has no bool type,
    takes the buffer."""
    n = tensors[0].shape[0]
    cols = []
    for t in tensors:
        t = t.detach().reshape(n, -1)
        if t.dtype == torch.bool:
            t = t.to(torch.int32)
        elif t.dtype == torch.float32:
            t = t.contiguous().view(torch.int32)
        elif t.dtype != torch.int32:
            raise TypeError(f"pack takes float32, int32 or bool, not {t.dtype}")
        cols.append(t)
    return torch.cat(cols, dim=1)


def unpack(buf, like):
    """Split a :func:`pack` buffer into tensors shaped and typed as
    ``like``."""
    out, c = [], 0
    for t in like:
        w = math.prod(t.shape[1:])
        col = buf[:, c:c + w].contiguous()
        c += w
        if t.dtype == torch.bool:
            col = col != 0
        elif t.dtype == torch.float32:
            col = col.view(torch.float32)
        out.append(col.reshape(t.shape))
    return out


# ---- rows and films --------------------------------------------------------

def _check_divisible(cfg, n_shards):
    rows_per = cfg.height // n_shards
    if rows_per * n_shards != cfg.height:
        raise ValueError(
            f"height {cfg.height} must divide by the mesh size {n_shards} "
            "(rays are sharded in whole image rows)")
    return rows_per


def shard_uids(cfg, mesh, device):
    """The global path uids of this shard's image rows."""
    n_loc = cfg.width * _check_divisible(cfg, mesh.size) * cfg.spp
    return torch.arange(mesh.rank * n_loc, (mesh.rank + 1) * n_loc,
                        dtype=torch.int64, device=device)


def gather_image(rows, mesh):
    """This shard's (rows_per, W, 3) block in uid order -> the whole
    (H, W, 3) image, row 0 = top, on every shard."""
    return torch.flip(all_gather_rows(rows, mesh), dims=(0,))


def sum_stats(stats, mesh):
    """The world's sum of a dict of float32 count tensors, in one
    all-reduce of a float64 buffer (the counts stay exact integers)."""
    keys = list(stats)
    flat = torch.cat([stats[k].reshape(-1).to(torch.float64) for k in keys])
    flat = all_reduce_sum(flat, mesh)
    out, c = {}, 0
    for k in keys:
        n = stats[k].numel()
        out[k] = flat[c:c + n].to(stats[k].dtype).reshape(stats[k].shape)
        c += n
    return out


class _AllReduceSum(torch.autograd.Function):
    """The world's sum, whose backward is the world's sum of the
    cotangents: the transpose of JAX's psum."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_reduce_sum(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.mesh), None


def own_splat_rows(splat, cfg, mesh, rows_per):
    """All-reduce the t=1 splat film (H*W, 3) over the mesh and return
    this shard's (rows_per, W, 3) row block.  The backward all-reduces
    the cotangent: a shard's light paths splat onto every shard's rows,
    so their gradient needs every shard's loss."""
    full = _AllReduceSum.apply(splat, mesh)
    r = mesh.rank
    return full.reshape(cfg.height, cfg.width, 3)[r * rows_per:
                                                  (r + 1) * rows_per]


# ---- renders ---------------------------------------------------------------

def _pt_rows(scene, cfg, mesh, intersect_fn=None, occluded_fn=None):
    """This shard's path-traced film rows in uid order, and its stats."""
    L, stats = trace_chunked(scene, shard_uids(cfg, mesh, scene.device), cfg,
                             intersect_fn=intersect_fn,
                             occluded_fn=occluded_fn)
    rows_per = _check_divisible(cfg, mesh.size)
    return film_from_radiance(L, cfg, rows=rows_per, flip=False), stats


def render_sharded(scene, cfg, mesh):
    """Full-frame path-traced render, rays sharded over the mesh.

    Returns (image (H,W,3), row 0 = top, stats summed over the mesh), on
    every shard: the bits of ``api.render`` on the scene's device."""
    img, stats = _pt_rows(scene, cfg, mesh)
    return gather_image(img, mesh), sum_stats(stats, mesh)


def _bdpt_rows(scene, cfg, mesh, intersect_fn=None, occluded_fn=None):
    """This shard's BDPT film rows in uid order: its paths' s=0 and t>=2
    strategies plus its rows of the all-reduced t=1 splat film."""
    from tputracer_torch.integrators.bdpt import trace_bdpt_rows

    rows_per = _check_divisible(cfg, mesh.size)
    n_total = cfg.width * cfg.height * cfg.spp
    L_own, splat, _ = trace_bdpt_rows(
        scene, shard_uids(cfg, mesh, scene.device), cfg,
        intersect_fn=intersect_fn, occluded_fn=occluded_fn)
    img = film_from_radiance(L_own, cfg, rows=rows_per, flip=False)
    return img + own_splat_rows(splat, cfg, mesh, rows_per) / float(n_total)


def render_bdpt_sharded(scene, cfg, mesh):
    """Full-frame BDPT render, rays sharded over the mesh -> (H,W,3).

    Matches ``api.render_bdpt`` up to the order of the splat's sums."""
    return gather_image(_bdpt_rows(scene, cfg, mesh), mesh)


# ---- fit steps -------------------------------------------------------------

def _leaves(params, device):
    """params as leaf tensors that require grad: the optimizer's own
    tensors as they are, anything else copied."""
    return {k: v if isinstance(v, torch.Tensor) and v.is_leaf
            and v.requires_grad
            else torch.as_tensor(v, dtype=torch.float32, device=device)
            .detach().clone().requires_grad_()
            for k, v in params.items()}


def fit_step_rows(scene, params, target, cfg, mesh, image_rows):
    """(loss, grads) of the mean squared pixel error, summed over the mesh.

    image_rows(scene with params) -> this shard's (rows_per, W, 3) film
    rows in uid order.  Each shard's loss is its rows' squared error over
    H*W*3; after the backward, the losses and gradients cross in one
    all-reduce of one buffer (the loss, then each parameter in the order
    of ``params``), so every shard returns the same bits."""
    rows_per = _check_divisible(cfg, mesh.size)
    dev = scene.device
    p = _leaves(params, dev)
    r = mesh.rank
    tgt = torch.flip(torch.as_tensor(target, dtype=torch.float32,
                                     device=dev), dims=(0,))
    tgt = tgt[r * rows_per:(r + 1) * rows_per]
    img = image_rows(dataclasses.replace(scene, **p))
    loss = torch.sum((img - tgt) ** 2) / float(cfg.height * cfg.width * 3)
    grads = torch.autograd.grad(loss, list(p.values()))
    flat = all_reduce_sum(torch.cat([loss.detach().reshape(1)]
                                    + [g.reshape(-1) for g in grads]), mesh)
    out, c = {}, 1
    for k, g in zip(p, grads):
        out[k] = flat[c:c + g.numel()].reshape(g.shape)
        c += g.numel()
    return flat[0], out


def fit_step_sharded(scene, params, target, cfg, mesh):
    """One inverse-rendering step on the mesh: (loss, grads), both summed
    over the mesh.  params: a dict of Scene table overrides; target: the
    (H,W,3) top-down target image, the same on every shard."""
    return fit_step_rows(scene, params, target, cfg, mesh,
                         lambda sc: _pt_rows(sc, cfg, mesh)[0])


def fit_step_bdpt_sharded(scene, params, target, cfg, mesh):
    """One inverse-rendering step through BDPT (cfg a BdptConfig), rays
    sharded over the mesh.  The t=1 splat film couples the shards: its
    gradient crosses them through :func:`own_splat_rows`' backward.
    Matches the single-device BDPT loss and gradients to float
    tolerance."""
    return fit_step_rows(scene, params, target, cfg, mesh,
                         lambda sc: _bdpt_rows(sc, cfg, mesh))


def fit_chain_sharded(scene, params, target, cfg, mesh, opt, n_steps):
    """n_steps optimizer steps of :func:`fit_step_sharded`: (n_steps,)
    losses, params updated in place (``fit.chain_steps``)."""
    from tputracer_torch.fit import chain_steps

    return chain_steps(
        lambda sc, p, t: fit_step_sharded(sc, p, t, cfg, mesh),
        scene, params, target, opt, n_steps)


def fit_step_opt_sharded(scene, params, target, cfg, mesh, opt):
    """One optimizer step of :func:`fit_step_sharded`: its loss (0-d)."""
    return fit_chain_sharded(scene, params, target, cfg, mesh, opt, 1)[0]


def fit_chain_bdpt_sharded(scene, params, target, cfg, mesh, opt, n_steps):
    """n_steps optimizer steps of :func:`fit_step_bdpt_sharded`."""
    from tputracer_torch.fit import chain_steps

    return chain_steps(
        lambda sc, p, t: fit_step_bdpt_sharded(sc, p, t, cfg, mesh),
        scene, params, target, opt, n_steps)
