"""The turntable: a look-dev viewer renders frame after frame through
``api.render`` while the camera yaws about the configuration's
``look_at`` and the light is rescaled a frame (``generator.Turntable``).
A frame runs from the edit to the image in host memory.  A seeded
reservoir keeps a few of the window's frames, which the reference
renders again once the program's state is freed."""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import check, generator, program
from perfbench.drive import Reservoir, Run, p95_ms


class Kind(Run):
    kind = "render"

    def setup(self):
        tr = self.traffic
        self.scene = self.build_scene()
        self.tt = generator.Turntable(tr, self.config["camera"], self.seed)
        self.cams = [program.camera(self.config["camera"], o, self.device)
                     for o in self.tt.origins]
        self.base_em = generator.material_tables(
            self.arrays.materials)["mat_emission"]
        self.base_em_dev = torch.as_tensor(self.base_em, device=self.device)
        self.factors = torch.as_tensor(self.tt.factors, device=self.device)
        self.cfg = program.render_config(tr["render"], self.seed)
        self.units = tr["traced_frames"]
        # the first call of a config runs eagerly, the second captures its
        # graph, the third replays it
        t = time.perf_counter()
        for _ in range(3):
            self.frame(0)
        self.host["warm_frames"] = [time.perf_counter() - t]

    def frame_scene(self, k):
        return program.with_tables(
            self.scene, camera=self.cams[self.tt.yaw_index(k)],
            mat_emission=self.base_em_dev
            * self.factors[k % generator.N_FACTORS])

    def emission_of(self, k):
        return self.base_em * self.tt.factor(k)

    def origin_of(self, k):
        return self.tt.origins[self.tt.yaw_index(k)]

    def frame(self, k):
        """Frame k as a viewer gets it: the light and camera edited, the
        render, the image in host memory.  (image, dispatch s, frame s)"""
        t0 = time.perf_counter()
        img = program.render(self.frame_scene(k), self.cfg)
        t1 = time.perf_counter()
        out = img.cpu().numpy()
        return out, t1 - t0, time.perf_counter() - t0

    def unit(self, u):
        self.frame(u)

    def replay(self, unit, on_closest, on_shadow):
        program.recorded_render(self.frame_scene(unit), self.cfg,
                                on_closest, on_shadow)

    def window(self, seconds):
        keep = Reservoir(self.traffic["check"]["frames"], self.seed)
        times, dispatch = [], []
        self.host["unit_s"] = times
        self.host["dispatch"] = dispatch
        t0 = time.perf_counter()
        self.t_window = t0
        while True:
            k = len(times)
            img, disp, dt = self.frame(k)
            times.append(dt)
            dispatch.append(disp)
            keep.offer((k, img))
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        self.kept = sorted(keep.items, key=lambda x: x[0])
        rays = len(times) * generator.flat_rays(self.traffic)
        return len(times), 0, {
            "rays_per_s": rays / elapsed,
            "frame_ms_p95": p95_ms(times)}

    def free(self):
        self.scene = self.cams = self.base_em_dev = self.factors = None

    def pixels(self):
        return check.pixel_sample(self.traffic["render"],
                                  self.traffic["check"]["pixels"], self.seed)

    def readings(self, frames):
        """The worst frame's numbers of ``frames``, [(k, image)]."""
        return check.worst(check.render_readings(
            self.arrays, self.config, self.traffic["render"], self.seed,
            frames, self.pixels(), self.device, self.emission_of,
            self.origin_of))

    def numbers(self):
        return self.readings(self.kept)

    def calibration_window(self, seconds):
        """The window, then the frames on either side of each kept one,
        for the stale-frame fault."""
        out = self.window(seconds)
        self.neighbours = {j: self.frame(j)[0] for k, _ in self.kept
                           for j in (k - 1, k + 1) if j >= 0}
        return out

    def faults(self):
        """The bfloat16 control; the program's frame scaled by 1.01 (an
        answer altered where it is made); the previous frame's image in
        the frame's place (a state left as it was); the float32 reference
        with half of each pixel's samples, the mean taken over the rest
        (half the batch left out)."""
        rend = self.traffic["render"]
        pixels = self.pixels()

        def as_image(px):
            flat = np.zeros((rend["width"] * rend["height"], 3), np.float32)
            flat[pixels] = px
            return flat.reshape(rend["height"], rend["width"], 3)[::-1]

        def reference(k, r, dtype):
            return as_image(check.reference_pixels(
                self.arrays, self.config, r, self.seed, self.emission_of(k),
                self.origin_of(k), pixels, self.device, dtype))

        half = dict(rend, spp=rend["spp"] // 2)
        nb = self.neighbours
        return {
            "control_bf16": self.readings(
                [(k, reference(k, rend, torch.bfloat16))
                 for k, _ in self.kept]),
            "fault_answer_altered": self.readings(
                [(k, img * np.float32(1.01)) for k, img in self.kept]),
            "fault_stale_frame": self.readings(
                [(k, nb[k - 1] if k else nb[1]) for k, _ in self.kept]),
            "fault_half_batch": self.readings(
                [(k, reference(k, half, torch.float32))
                 for k, _ in self.kept])}
