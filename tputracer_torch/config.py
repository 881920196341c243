"""Render configuration, field for field the JAX package's ``RenderConfig``.

The same field names and defaults as ``tputracer/config.py`` mean one set
of values drives both packages (the parity tests build one config and hand
it to each).  As in the JAX package, a config is a static argument of the
compiled render entry points: it is part of their CUDA graphs' key
(tputracer_torch.graphs), so the dataclasses stay frozen and hashable.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class RenderConfig:
    width: int = 512
    height: int = 512
    spp: int = 16
    max_bounces: int = 4          # scatter events; total path verts = +1
    rr_start: int = 3             # first bounce with Russian roulette
    seed: int = 0
    mis: bool = False             # False = NEE only; True = power-heuristic
                                  # MIS between NEE and BSDF sampling
    chunk_size: int = 1 << 20     # wavefront paths per chunk (memory knob)
    transport_radiance: bool = True
    remat: bool = False           # per-bounce recomputation in backward;
                                  # the forward pass is unchanged by it
    sort_rays: bool = False       # per-bounce wavefront re-sort (clustered
                                  # scenes only); the image keeps its bits

    def with_(self, **kw):
        return replace(self, **kw)


@dataclass(frozen=True)
class BdptConfig:
    """Bidirectional path tracer config, field for field the JAX package's.

    ``max_bounces`` mirrors RenderConfig: a full path has at most
    ``max_bounces + 2`` vertices including the camera, so PT and BDPT with
    equal ``max_bounces`` integrate the same path space.
    """
    width: int = 512
    height: int = 512
    spp: int = 16
    max_bounces: int = 4          # max surface scatter events on a full path
    seed: int = 0
    chunk_size: int = 1 << 16     # paths per chunk, rounded down to rows
    transport_radiance: bool = True
    mis_power: bool = False       # False = balance heuristic; True = Veach
                                  # power heuristic (beta=2)

    def with_(self, **kw):
        return replace(self, **kw)
