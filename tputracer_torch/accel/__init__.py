"""Intersection backends, picked by the device of the rays.

CUDA tensors go to the fused CUDA kernel (accel.intersect_cuda); CPU
tensors go to the brute-force port (accel.bruteforce), the same backend
the JAX package takes on the CPU.  Scenes with a cluster BVH are not
supported yet.
"""

from tputracer_torch.accel.bruteforce import (  # noqa: F401
    Hit,
    finalize_hit,
    intersect_brute,
    occluded_brute,
)
from tputracer_torch.accel.intersect_cuda import (  # noqa: F401
    intersect_fused,
    intersect_plain,
    occluded_fused,
    occluded_plain,
)


def _route(scene, o):
    if scene.n_clusters:
        raise NotImplementedError(
            "clustered scenes are not supported by tputracer_torch yet")
    if o.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no intersection route for device {o.device}")
    return o.device.type == "cuda"


def intersect(scene, o, d, tmin, tmax) -> Hit:
    """Closest hit over the scene."""
    if _route(scene, o):
        return intersect_fused(scene, o, d, tmin, tmax)
    return intersect_brute(scene, o, d, tmin, tmax)


def occluded(scene, o, d, tmax):
    """Any-hit shadow predicate."""
    if _route(scene, o):
        return occluded_fused(scene, o, d, tmax)
    return occluded_brute(scene, o, d, tmax)
