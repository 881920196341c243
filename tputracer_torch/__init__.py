"""tputracer_torch — the tputracer path tracer in PyTorch, for NVIDIA Hopper.

A port of the JAX package ``tputracer`` (which stays the reference):
the same scenes, configs, counter-based RNG, wavefront path tracer,
bidirectional path tracer and progressive renders with film checkpoints,
written as plain functions on tensors, with the ray-intersection kernels
written by hand in CUDA (``csrc/``, built with nvcc at first use, never at
import).  On CPU tensors every kernel is replaced by its plain PyTorch
version.  This package imports neither ``jax`` nor ``tputracer``.
"""

__version__ = "0.1.0"

from tputracer_torch.api import (  # noqa: F401
    render,
    render_bdpt,
    render_bdpt_progressive,
    render_progressive,
)
