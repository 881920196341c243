"""Intersection backends, picked by the scene's layout and the rays' device.

  * scenes with a cluster BVH (scene.n_clusters > 0): CUDA tensors go to
    the traversal kernel (accel.traverse_cuda), or, with TPUTRACER_PAIRS
    set (read at each call, as the JAX package reads it), to the
    pair-expansion route (accel.pairs: the expand and pair-test kernels,
    then the traversal kernel for the rays their K slots leave open).  CPU
    tensors go to the plain clustered walk (accel.clustered) whatever the
    variable says, as the JAX package takes pairs only on the TPU;
  * other scenes: CUDA tensors go to the fused intersection kernel
    (accel.intersect_cuda), CPU tensors to brute force (accel.bruteforce).

:func:`closest` is the closest hit's (t, prim) before ``finalize_hit``
turns it into a Hit, which PT's kernels do themselves on the card.

``intersect_plain``/``occluded_plain`` and ``intersect_clustered``/
``occluded_clustered`` run the kernels' plain versions on any device, and
``intersect_pairs``/``occluded_pairs`` the pair route on any device; they
plug into ``render_pt(..., intersect_fn=..., occluded_fn=...)`` to compare
a render through one route with one through another.
"""

import os

from tputracer_torch.accel.bruteforce import (  # noqa: F401
    Hit,
    closest_brute,
    finalize_hit,
    intersect_brute,
    occluded_brute,
)
from tputracer_torch.accel.clustered import (  # noqa: F401
    closest_clustered,
    intersect_clustered,
    occluded_clustered,
)
from tputracer_torch.accel.intersect_cuda import (  # noqa: F401
    closest_fused,
    intersect_fused,
    intersect_plain,
    occluded_fused,
    occluded_plain,
)
from tputracer_torch.accel.pairs import (  # noqa: F401
    closest_pairs,
    intersect_pairs,
    occluded_pairs,
)
from tputracer_torch.accel.traverse_cuda import (  # noqa: F401
    closest_traverse,
    intersect_traverse,
    occluded_traverse,
)


def _on_card(o):
    if o.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no intersection route for device {o.device}")
    return o.device.type == "cuda"


def _use_pairs():
    """The pair-expansion route, opt-in via TPUTRACER_PAIRS=1."""
    return bool(os.environ.get("TPUTRACER_PAIRS"))


def closest(scene, o, d, tmin, tmax):
    """(t, prim) of the closest hit over the scene: t < tmax where a ray
    hits, prim its primitive id (spheres after the padded triangles)."""
    if scene.n_clusters:
        if _on_card(o):
            if _use_pairs():
                return closest_pairs(scene, o, d, tmin, tmax)
            return closest_traverse(scene, o, d, tmin, tmax)
        return closest_clustered(scene, o, d, tmin, tmax)
    if _on_card(o):
        return closest_fused(scene, o, d, tmin, tmax)
    return closest_brute(scene, o, d, tmin, tmax)


def intersect(scene, o, d, tmin, tmax) -> Hit:
    """Closest hit over the scene: :func:`closest`, then ``finalize_hit``."""
    t, prim = closest(scene, o, d, tmin, tmax)
    return finalize_hit(scene, o, d, t, prim, t < tmax)


def occluded(scene, o, d, tmax):
    """Any-hit shadow predicate."""
    if scene.n_clusters:
        if _on_card(o):
            if _use_pairs():
                return occluded_pairs(scene, o, d, tmax)
            return occluded_traverse(scene, o, d, tmax)
        return occluded_clustered(scene, o, d, tmax)
    if _on_card(o):
        return occluded_fused(scene, o, d, tmax)
    return occluded_brute(scene, o, d, tmax)
