"""PT's bounce on the card: ``csrc/pt.cu``.

:func:`bounce_cuda` computes what ``pt._bounce_step_plain`` computes, one
wavefront bounce of a chunk, in two kernels around the shadow rays: the
caller's closest-hit call gives (t, prim) (``accel.closest``),
``pt_prepare_kernel`` shades the hit (emission, NEE's light sample and
shadow ray), the caller's ``occl`` traces the shadow rays as the torch
version does, and ``pt_finish_kernel`` adds NEE where the light is clear,
samples the BSDF, plays Russian roulette and writes the next ray.  The
kernels update the seven carry tensors in place and draw their samples
themselves (``csrc/pcg3d.cuh``, ``rng.uniform3``'s bits).

``pt.trace_radiance`` routes (``pt.pt_on_card``): CUDA tensors with no
gradient wanted, no ``decision_scene`` and the default intersectors come
here; the rest takes the torch version, which is also the kernels'
oracle.  The kernels have no backward.  Built at first use
(``cuda_build``), never at import.
"""

from __future__ import annotations

import ctypes

import torch

from tputracer_torch.cuda_build import Library, check, owned

_BIG = 3.0e38
_WHO = "bounce_cuda"

# the scene's tables the kernels read, with each one's dtype and trailing
# shape; the leading dimension is the table's own
TABLES = {"tri_n": (torch.float32, (3,)), "tri_mat": (torch.int32, ()),
          "sph_c": (torch.float32, (3,)), "sph_r": (torch.float32, ()),
          "sph_mat": (torch.int32, ()), "mat_kind": (torch.int32, ()),
          "mat_albedo": (torch.float32, (3,)),
          "mat_emission": (torch.float32, (3,)),
          "mat_ior": (torch.float32, ()), "emit_prim": (torch.int32, ()),
          "emit_area": (torch.float32, ()), "emit_v0": (torch.float32, (3,)),
          "emit_e1": (torch.float32, (3,)), "emit_e2": (torch.float32, (3,)),
          "emit_n": (torch.float32, (3,)), "emit_mat": (torch.int32, ())}
# the carry's tensors, in trace_radiance's order, each (n,) + trailing
CARRY = {"o": (torch.float32, (3,)), "d": (torch.float32, (3,)),
         "L": (torch.float32, (3,)), "thr": (torch.float32, (3,)),
         "alive": (torch.bool, ()), "prev_delta": (torch.bool, ()),
         "prev_pdf": (torch.float32, ())}


class Args(ctypes.Structure):
    """csrc/pt.cu's ``Args``, field for field."""

    _fields_ = ([(k, ctypes.c_void_p) for k in (
        *TABLES, "uid", "t", "prim", *CARRY, "tmax", "so", "sd", "stmax",
        "contrib", "flags", "occ", "counts")]
        + [("n", ctypes.c_longlong)]
        + [(k, ctypes.c_int) for k in (
            "n_tri_pad", "n_emit", "bounce", "max_bounces", "rr_start", "mis",
            "transport")]
        + [("seed", ctypes.c_uint), ("eps", ctypes.c_float)])


_ARGS = ctypes.POINTER(Args)
LIB = Library("pt.cu", "tpt_pt_error_string", {
    "tpt_pt_prepare": ([_ARGS], ["pt_prepare_kernel"]),
    "tpt_pt_finish": ([_ARGS], ["pt_finish_kernel"])})


class Wavefront:
    """A chunk's state on the kernels' route besides the carry: the
    scene's checked tables, the closest-hit call's tmin and tmax (which
    the finish kernel writes for the next bounce), the shadow rays, the
    stash and the (3, max_bounces + 1) int32 ray counts.  Made once a
    chunk; raises ValueError, before any build or launch, on a table or
    uid the kernels do not take (each on one device, contiguous, of its
    dtype and shape, and that device a CUDA one) or a scene without an
    emitter."""

    def __init__(self, scene, uid, cfg):
        dev = uid.device
        n = uid.shape[0]
        check(_WHO, "uid", uid, torch.int64, (n,), dev)
        a = self.args = Args()
        for name, (dtype, tail) in TABLES.items():
            t = getattr(scene, name)
            ptr = check(_WHO, name, t, dtype, t.shape[:1] + tail, dev)
            setattr(a, name, ptr)
        if scene.n_emitters == 0:
            raise ValueError(f"{_WHO}: the scene has no emitter to sample")
        if dev.type != "cuda":
            raise ValueError(f"{_WHO}: want CUDA tensors, got {dev}")
        a.n, a.n_tri_pad, a.n_emit = n, scene.n_tri_pad, scene.n_emitters
        a.max_bounces, a.rr_start = cfg.max_bounces, cfg.rr_start
        a.mis, a.transport = int(bool(cfg.mis)), int(
            bool(cfg.transport_radiance))
        a.seed, a.eps = int(cfg.seed) & 0xFFFFFFFF, scene.eps
        self.scene, self.n, self.device = scene, n, dev
        f32 = dict(dtype=torch.float32, device=dev)
        self.tmin = torch.zeros((n,), **f32)
        self.tmax = torch.full((n,), _BIG, **f32)
        self.so = torch.empty((n, 3), **f32)
        self.sd = torch.empty((n, 3), **f32)
        self.stmax = torch.empty((n,), **f32)
        self.contrib = torch.empty((n, 3), **f32)
        self.flags = torch.empty((n,), dtype=torch.uint8, device=dev)
        self.counts = torch.zeros((3, cfg.max_bounces + 1), dtype=torch.int32,
                                  device=dev)
        for k in ("so", "sd", "stmax", "contrib", "flags", "counts"):
            setattr(a, k, getattr(self, k).data_ptr())

    def permute(self, perm):
        """Put the next bounce's tmax in the order ``perm`` (sort_rays)."""
        self.tmax = self.tmax[perm]


def bounce_cuda(wave, uid, carry, *, b, closest=None, occl=None):
    """``pt._bounce_step_plain``'s bounce ``b`` on the card, the carry
    updated in place (``o`` copied first where it is a view or not
    contiguous: ``cuda_build.owned``): returns
    (carry, (rays_issued, n_active, rays_shadow)), the counts 0-d int32
    views of ``wave.counts`` (rays_shadow None on the last bounce).
    ``closest`` (default ``accel.closest``) gives the closest hit's
    (t, prim); ``occl`` (default ``accel.occluded``) traces the shadow
    rays."""
    from tputracer_torch.accel import closest as closest_hit
    from tputracer_torch.accel import occluded

    closest = closest_hit if closest is None else closest
    occl = occluded if occl is None else occl
    a, dev, n = wave.args, wave.device, wave.n
    o, d, L, thr, alive, prev_delta, prev_pdf = carry
    o = owned(o)
    carry = (o, d, L, thr, alive, prev_delta, prev_pdf)
    check(_WHO, "uid", uid, torch.int64, (n,), dev)
    a.uid = uid.data_ptr()
    for (name, (dtype, tail)), x in zip(CARRY.items(), carry):
        setattr(a, name, check(_WHO, name, x, dtype, (n,) + tail, dev))
    a.tmax = check(_WHO, "tmax", wave.tmax, torch.float32, (n,), dev)
    a.bounce = b
    t, prim = closest(wave.scene, o, d, wave.tmin, wave.tmax)
    a.t = check(_WHO, "t", t, torch.float32, (n,), dev)
    a.prim = check(_WHO, "prim", prim, torch.int32, (n,), dev)
    LIB.launch("tpt_pt_prepare", dev, ctypes.byref(a))
    counts = wave.counts[:, b]
    if b == a.max_bounces:
        return carry, (counts[0], counts[1], None)
    occ = occl(wave.scene, wave.so, wave.sd, tmax=wave.stmax)
    a.occ = check(_WHO, "occ", occ, torch.bool, (n,), dev)
    LIB.launch("tpt_pt_finish", dev, ctypes.byref(a))
    return carry, (counts[0], counts[1], counts[2])
