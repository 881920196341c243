"""Scene and camera as small dataclasses of SoA tensors.

Port of ``tputracer/scene/types.py``: the same field names, dtypes and
shapes, so a scene built by either package can be carried into the other
(:func:`scene_from_numpy`).  The host-side builders are the same NumPy
code; only the last step, moving the arrays into tensors on ``device``,
differs.

Triangles carry Pluecker edge coordinates (``plu``, shape (3, 6, T)): the
edge-sign test of a ray against a triangle is then a 6-term dot product
per edge (accel.bruteforce, accel.intersect_cuda).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from tputracer_torch.accel.toptree import top_boxes
from tputracer_torch.trace import span, spanned

# material kinds
DIFFUSE = 0
MIRROR = 1
GLASS = 2


@dataclass(frozen=True)
class Camera:
    """Pinhole camera: ray(u, v) = normalize(corner + u*du + v*dv - o)."""

    o: torch.Tensor        # (3,)
    corner: torch.Tensor   # (3,) world point of pixel (0,0) corner
    du: torch.Tensor       # (3,) full horizontal image-plane span
    dv: torch.Tensor       # (3,) full vertical image-plane span

    def to(self, device):
        return Camera(*(getattr(self, f.name).to(device)
                        for f in dataclasses.fields(self)))


@dataclass(frozen=True)
class Scene:
    # triangles (padded to `n_tri_pad`; valid count = n_tris)
    tri_v0: torch.Tensor   # (T,3)
    tri_e1: torch.Tensor   # (T,3)  v1 - v0
    tri_e2: torch.Tensor   # (T,3)  v2 - v0
    tri_n: torch.Tensor    # (T,3)  cross(e1, e2), unnormalized
    tri_mat: torch.Tensor  # (T,) int32 (padding rows point at material 0)
    tri_mask: torch.Tensor  # (T,) f32 1.0 valid / 0.0 padding
    plu: torch.Tensor      # (3, 6, T) Pluecker edge matrix

    # spheres
    sph_c: torch.Tensor    # (S,3)
    sph_r: torch.Tensor    # (S,)
    sph_mat: torch.Tensor  # (S,) int32

    # material tables — the differentiable parameters
    mat_kind: torch.Tensor      # (M,) int32 in {DIFFUSE, MIRROR, GLASS}
    mat_albedo: torch.Tensor    # (M,3)
    mat_emission: torch.Tensor  # (M,3)
    mat_ior: torch.Tensor       # (M,)

    # emitters: emissive triangle ids + areas, and a compact copy of their
    # geometry so light sampling indexes small tables
    emit_prim: torch.Tensor  # (E,) int32 triangle ids
    emit_area: torch.Tensor  # (E,) f32
    emit_v0: torch.Tensor    # (E,3)
    emit_e1: torch.Tensor    # (E,3)
    emit_e2: torch.Tensor    # (E,3)
    emit_n: torch.Tensor     # (E,3) unit normals (emitting side)
    emit_mat: torch.Tensor   # (E,) int32

    # 2-level cluster BVH (accel.bvh; empty => brute-force intersection).
    # Triangle tables are then cluster-major: cluster c owns the slots
    # [c*leaf_size, (c+1)*leaf_size).
    clus_min: torch.Tensor  # (C,3)
    clus_max: torch.Tensor  # (C,3)
    # its top level (accel.toptree, the port's own): one box over each run
    # of toptree.FANOUT clusters, which kernel B2 walks first where the
    # cluster boxes outgrow its shared memory
    top_min: torch.Tensor   # (G,3)
    top_max: torch.Tensor   # (G,3)

    camera: Camera

    n_tris: int = 0
    eps: float = 1e-4
    leaf_size: int = 128

    @property
    def n_tri_pad(self):
        return self.tri_v0.shape[0]

    @property
    def n_spheres(self):
        return self.sph_c.shape[0]

    @property
    def n_emitters(self):
        return self.emit_prim.shape[0]

    @property
    def n_clusters(self):
        return self.clus_min.shape[0]

    @property
    def device(self):
        return self.tri_v0.device

    def to(self, device):
        """The same scene with every tensor on ``device``."""
        kw = {f: getattr(self, f).to(device)
              for f in TENSOR_FIELDS + TREE_FIELDS}
        return dataclasses.replace(self, camera=self.camera.to(device), **kw)


# the port's own Scene tensors, computed from the cluster boxes
TREE_FIELDS = ("top_min", "top_max")
# the Scene fields that hold tensors (the camera, the statics and
# TREE_FIELDS aside): the JAX package's Scene leaves
TENSOR_FIELDS = tuple(f.name for f in dataclasses.fields(Scene)
                      if f.name not in ("camera", "n_tris", "eps",
                                        "leaf_size") + TREE_FIELDS)
CAMERA_FIELDS = tuple(f.name for f in dataclasses.fields(Camera))


def wants_grad(scene):
    """Whether a call on ``scene`` wants a gradient: grad enabled and a
    scene or camera tensor requiring grad.  The hand-written kernels have
    no backward, so such calls take the torch routes."""
    cam = scene.camera
    return torch.is_grad_enabled() and any(
        x.requires_grad for x in [getattr(scene, f) for f in TENSOR_FIELDS]
        + [getattr(cam, f) for f in CAMERA_FIELDS])


def kernel_route(scene, device, what, *hooks, tensors=()):
    """Whether a call on ``scene`` with tensors on ``device`` takes the
    card's hand-written kernels: a CUDA device, no hook injected (every one
    of ``hooks`` None) and no gradient wanted (:func:`wants_grad`, or grad
    enabled and one of ``tensors`` requiring grad).  CPU calls take the
    torch route; any other device raises ValueError naming ``what``'s
    route."""
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"no {what} route for device {device}")
    if any(h is not None for h in hooks):
        return False
    return not (wants_grad(scene) or (torch.is_grad_enabled() and any(
        t.requires_grad for t in tensors)))


def _tensor(x, dtype, device):
    # np.array copies: the source may be a read-only view (a JAX leaf)
    return torch.from_numpy(np.array(x, dtype=dtype, order="C")).to(device)


def make_camera(o, look_at, up, vfov_deg, aspect, device="cuda"):
    """Build a Camera from look-at parameters (host-side NumPy), on
    ``device`` (the card unless the caller asks for the CPU)."""
    o = np.asarray(o, np.float32)
    w = np.asarray(look_at, np.float32) - o
    w = w / np.linalg.norm(w)
    up = np.asarray(up, np.float32)
    u = np.cross(w, up)
    u = u / np.linalg.norm(u)
    v = np.cross(u, w)
    h = np.tan(np.radians(vfov_deg) * 0.5)
    du = 2.0 * h * aspect * u
    dv = 2.0 * h * v
    corner = o + w - 0.5 * du - 0.5 * dv
    return Camera(*(_tensor(x, np.float32, device)
                    for x in (o, corner, du, dv)))


def _pluecker_matrix(v0, v1, v2):
    """Per-edge Pluecker coords [a x b, b - a] of edges (v1,v2), (v2,v0),
    (v0,v1); the signed permuted inner product with a ray feature
    [d, o x d] is then a dot product.  Returns (3, 6, T) float32."""
    edges = [(v1, v2), (v2, v0), (v0, v1)]
    out = []
    for a, b in edges:
        e = b - a                      # (T,3)
        m = np.cross(a, b)             # (T,3)
        out.append(np.concatenate([m, e], axis=1).T)  # (6,T)
    return np.stack(out, axis=0).astype(np.float32)   # (3,6,T)


@spanned("scene.build")
def make_scene(
    tri_vertices,      # (T,3,3) float — [v0, v1, v2] per triangle
    tri_mat,           # (T,) int
    materials,         # list of dicts: kind, albedo, emission, ior
    spheres=(),        # list of (center(3), radius, mat_id)
    camera=None,
    pad_to=128,
    eps=1e-4,
    accel="auto",      # "auto" | "cluster" | "none"
    leaf_size=128,
    cluster_threshold=2048,  # "auto": cluster scenes above this tri count
    device="cuda",
):
    """Host-side scene finalization: SoA arrays + Pluecker precompute +
    padding, moved to ``device`` (the card unless the caller asks for the
    CPU).  Large meshes (or ``accel="cluster"``)
    also get the 2-level cluster BVH (accel.bvh): the triangle tables are
    laid out cluster-major, with one AABB per cluster."""
    tv = np.asarray(tri_vertices, np.float32)
    if tv.ndim != 3 or tv.shape[1:] != (3, 3):
        raise ValueError(f"tri_vertices must be (T,3,3), got {tv.shape}")
    T = tv.shape[0]

    if accel == "cluster" or (accel == "auto" and T > cluster_threshold):
        from tputracer_torch.accel.bvh import build_clusters

        with span("scene.bvh") as rec:
            perm, mask, cmin, cmax = build_clusters(tv, leaf_size=leaf_size)
            top = [x.numpy() for x in top_boxes(torch.from_numpy(cmin),
                                                torch.from_numpy(cmax))]
            rec.add(clusters=len(cmin), top_nodes=len(top[0]))
        # padding slots repeat triangle 0; zero their geometry so they are
        # degenerate (never intersected) and point them at material 0
        v0 = tv[perm, 0] * mask[:, None]
        v1 = tv[perm, 1] * mask[:, None]
        v2 = tv[perm, 2] * mask[:, None]
        mat = (np.asarray(tri_mat, np.int32)[perm]
               * (mask > 0)).astype(np.int32)
    else:
        Tp = max(pad_to, int(np.ceil(T / pad_to)) * pad_to)
        v0 = np.zeros((Tp, 3), np.float32)
        v1 = np.zeros((Tp, 3), np.float32)
        v2 = np.zeros((Tp, 3), np.float32)
        v0[:T], v1[:T], v2[:T] = tv[:, 0], tv[:, 1], tv[:, 2]
        # padding rows stay degenerate (zeros) and are masked out by tri_mask
        mat = np.zeros((Tp,), np.int32)
        mat[:T] = np.asarray(tri_mat, np.int32)
        mask = np.zeros((Tp,), np.float32)
        mask[:T] = 1.0
        cmin = np.zeros((0, 3), np.float32)
        cmax = np.zeros((0, 3), np.float32)
        top = [cmin, cmax]

    e1 = v1 - v0
    e2 = v2 - v0
    n = np.cross(e1, e2)

    m_kind = np.array([m["kind"] for m in materials], np.int32)
    m_alb = np.array([m.get("albedo", (0, 0, 0)) for m in materials], np.float32)
    m_emit = np.array([m.get("emission", (0, 0, 0)) for m in materials], np.float32)
    m_ior = np.array([m.get("ior", 1.5) for m in materials], np.float32)

    # emitters = valid triangles whose material emits
    emissive_mat = np.any(m_emit > 0.0, axis=1)
    emit_ids = np.nonzero(emissive_mat[mat] & (mask > 0))[0].astype(np.int32)
    areas = 0.5 * np.linalg.norm(n[emit_ids], axis=1).astype(np.float32)

    if spheres:
        sc = np.array([s[0] for s in spheres], np.float32).reshape(-1, 3)
        sr = np.array([s[1] for s in spheres], np.float32)
        sm = np.array([s[2] for s in spheres], np.int32)
    else:
        sc = np.zeros((0, 3), np.float32)
        sr = np.zeros((0,), np.float32)
        sm = np.zeros((0,), np.int32)

    emit_n = n[emit_ids] / np.maximum(
        np.linalg.norm(n[emit_ids], axis=1, keepdims=True), 1e-20
    ).astype(np.float32)
    arrays = dict(
        tri_v0=v0, tri_e1=e1, tri_e2=e2, tri_n=n, tri_mat=mat, tri_mask=mask,
        plu=_pluecker_matrix(v0, v1, v2),
        sph_c=sc, sph_r=sr, sph_mat=sm,
        mat_kind=m_kind, mat_albedo=m_alb, mat_emission=m_emit, mat_ior=m_ior,
        emit_prim=emit_ids, emit_area=areas, emit_v0=v0[emit_ids],
        emit_e1=e1[emit_ids], emit_e2=e2[emit_ids], emit_n=emit_n,
        emit_mat=mat[emit_ids],
        clus_min=cmin, clus_max=cmax, top_min=top[0], top_max=top[1],
    )
    if camera is not None:
        arrays["camera"] = {k: getattr(camera, k).cpu().numpy()
                            for k in CAMERA_FIELDS}
    return scene_from_numpy(arrays, n_tris=T, eps=eps, leaf_size=leaf_size,
                            device=device)


def scene_from_numpy(arrays, *, n_tris, eps, leaf_size, device):
    """Build a Scene from host arrays keyed by field name.

    ``arrays`` maps every name of TENSOR_FIELDS to an array, and
    ``"camera"`` to a dict of the four :class:`Camera` arrays (or None).
    This is how a scene crosses from the JAX package: pass the ``np.asarray``
    of each of its leaves, and both packages see byte-identical geometry.
    Integer fields become int32 and float fields float32, as in the JAX
    package (which downcasts float64 host values the same way).  The
    port's own TREE_FIELDS are taken from ``arrays`` where it has them,
    else computed from the cluster boxes (``accel.toptree.top_boxes``).
    """
    kw = {}
    for name in TENSOR_FIELDS + tuple(f for f in TREE_FIELDS if f in arrays):
        a = np.asarray(arrays[name])
        dtype = np.int32 if np.issubdtype(a.dtype, np.integer) else np.float32
        kw[name] = _tensor(a, dtype, device)
    if not all(name in kw for name in TREE_FIELDS):
        kw["top_min"], kw["top_max"] = top_boxes(kw["clus_min"],
                                                 kw["clus_max"])
    cam = arrays.get("camera")
    camera = None if cam is None else Camera(
        *(_tensor(cam[k], np.float32, device) for k in CAMERA_FIELDS))
    return Scene(camera=camera, n_tris=int(n_tris), eps=float(eps),
                 leaf_size=int(leaf_size), **kw)
