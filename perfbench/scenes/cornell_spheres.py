"""The Cornell box with a glass and a mirror sphere, in [0,1]^3 (x right,
y up, z into the box), as ``cornell_box("spheres")`` builds it: the
room's five walls and the classic ceiling light, 12 triangles, and the
two spheres.  The caustics box differs only in the light and spheres the
configuration gives, so its ``build`` makes this one too."""

from perfbench.scenes.cornell_caustic import build

__all__ = ["build"]
