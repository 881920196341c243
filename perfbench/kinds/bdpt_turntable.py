"""The BDPT turntable: the turntable's look-dev viewer, orbit and light
edit (``generator.Turntable``), each frame rendered through
``api.render_bdpt``.  A frame runs from the edit to the image in host
memory.  A seeded reservoir keeps a few of the window's frames, which the
BDPT reference (``perfbench/reference/bdpt.py``) renders again whole once
the program's state is freed: a path's t = 1 splat can land on any pixel,
so no pixel can be judged without all the paths."""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import bench, check, generator, program
from perfbench.reference import bdpt as ref_bdpt
from perfbench.reference import pt as ref_pt


def flat_rays(traffic):
    """Flat rays of one BDPT frame, ``benchmarks/run.py:155-176``'s count:
    paths x (the two walks' 2 (B + 1) segments + one ray a strategy of 2
    to B + 2 vertices, (B + 2)(B + 3) / 2 - 1)."""
    r = traffic["render"]
    b = r["max_bounces"]
    return (r["width"] * r["height"] * r["spp"]
            * (2 * (b + 1) + (b + 2) * (b + 3) // 2 - 1))


def render_config(render, seed):
    from tputracer_torch.config import BdptConfig

    return BdptConfig(seed=seed, **render)


def render(scene, cfg):
    """``api.render_bdpt``: the frame's (H, W, 3) image on the device."""
    from tputracer_torch import api

    return api.render_bdpt(scene, cfg)[0]


def emitters(arrays):
    """The emitter triangles' ids, in the arrays' order."""
    emits = [any(c > 0 for c in m["emission"]) for m in arrays.materials]
    return [i for i, m in enumerate(arrays.tri_mat) if emits[int(m)]]


class Kind(bench.kind("turntable")):
    def setup(self):
        tr = self.traffic
        self.scene = self.build_scene()
        # the reference takes the emitters in the arrays' order, which the
        # program keeps where no cluster BVH lays out its triangles
        got = self.scene.emit_prim.cpu().tolist()
        if self.scene.n_clusters or got != emitters(self.arrays):
            raise RuntimeError(
                f"the program's emitters {got} are not the arrays' "
                f"{emitters(self.arrays)}")
        self.tt = generator.Turntable(tr, self.config["camera"], self.seed)
        self.cams = [program.camera(self.config["camera"], o, self.device)
                     for o in self.tt.origins]
        self.base_em = generator.material_tables(
            self.arrays.materials)["mat_emission"]
        self.base_em_dev = torch.as_tensor(self.base_em, device=self.device)
        self.factors = torch.as_tensor(self.tt.factors, device=self.device)
        self.cfg = render_config(tr["render"], self.seed)
        self.units = tr["traced_frames"]
        # the first call of a config runs eagerly, the second captures its
        # graph, the third replays it
        t = time.perf_counter()
        for _ in range(3):
            self.frame(0)
        self.host["warm_frames"] = [time.perf_counter() - t]

    def frame(self, k):
        """Frame k as a viewer gets it: the light and camera edited, the
        render, the image in host memory.  (image, dispatch s, frame s)"""
        t0 = time.perf_counter()
        img = render(self.frame_scene(k), self.cfg)
        t1 = time.perf_counter()
        out = img.cpu().numpy()
        return out, t1 - t0, time.perf_counter() - t0

    def window(self, seconds):
        attempted, failed, e2e = super().window(seconds)
        # the turntable counts a PT frame's flat rays
        e2e["rays_per_s"] *= flat_rays(self.traffic) / generator.flat_rays(
            self.traffic)
        return attempted, failed, e2e

    def replay(self, unit, on_closest, on_shadow):
        """An eager ``render_bdpt`` of traced frame ``unit`` through the
        program's own intersection route, with hooks that see each call:
        on_closest(scene, o, d, tmin, tmax, hit) and on_shadow(scene, o,
        d, tmax, occluded)."""
        from tputracer_torch.accel import intersect, occluded
        from tputracer_torch.integrators.bdpt import render_bdpt

        def isect(sc, o, d, tmin, tmax):
            hit = intersect(sc, o, d, tmin, tmax)
            on_closest(sc, o, d, tmin, tmax, hit)
            return hit

        def occl(sc, o, d, tmax):
            occ = occluded(sc, o, d, tmax)
            on_shadow(sc, o, d, tmax, occ)
            return occ

        with torch.no_grad():
            render_bdpt(self.frame_scene(unit), self.cfg, intersect_fn=isect,
                        occluded_fn=occl)

    def reference(self, k, r, dtype):
        """The reference's (H, W, 3) float32 image of frame k under render
        settings r, computed in ``dtype``."""
        cam = self.config["camera"]
        sc = ref_pt.make_ref_scene(
            self.arrays, eps=self.config["scene"]["eps"], device=self.device,
            dtype=dtype, emission=torch.as_tensor(self.emission_of(k),
                                                  device=self.device))
        c = ref_pt.camera(self.origin_of(k), cam["look_at"], cam["up"],
                          cam["vfov_deg"], cam["aspect"], self.device, dtype)
        img = ref_bdpt.render_image(sc, c, r, self.seed,
                                    power=r["mis_power"])
        return img.float().cpu().numpy()

    def readings(self, frames):
        """The worst frame's numbers of ``frames``, [(k, image)], each
        image against the float32 reference's, pixel by pixel."""
        r = self.traffic["render"]
        return check.worst([check.image_numbers(
            img.reshape(-1, 3),
            self.reference(k, r, torch.float32).reshape(-1, 3))
            for k, img in frames])

    def faults(self):
        """The bfloat16 control; the program's frame scaled by 1.01 (an
        answer altered where it is made); the previous frame's image in
        the frame's place (a state left as it was); the float32 reference
        with half of each pixel's samples (half the batch left out)."""
        r = self.traffic["render"]
        half = dict(r, spp=r["spp"] // 2)
        nb = self.neighbours
        return {
            "control_bf16": self.readings(
                [(k, self.reference(k, r, torch.bfloat16))
                 for k, _ in self.kept]),
            "fault_answer_altered": self.readings(
                [(k, img * np.float32(1.01)) for k, img in self.kept]),
            "fault_stale_frame": self.readings(
                [(k, nb[k - 1] if k else nb[1]) for k, _ in self.kept]),
            "fault_half_batch": self.readings(
                [(k, self.reference(k, half, torch.float32))
                 for k, _ in self.kept])}
