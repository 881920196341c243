"""The fit: inverse rendering in chains of ``chain`` optimizer steps
through ``fit._fit_chain_single`` (the chain ``fit.fit`` runs on one
device), with the fit's own Adam (``fit._adam``), toward the true render,
from the traffic's start tables; the losses are read once a chain.

Set-up takes the first ``checked_chains`` chains through the window's own
call and size, and the same parameters and optimizer go on into the
window.  The reference follows those steps from the start: each step's
loss, the first gradient as the optimizer got it (from its state after
the first step) and the tables' change after the last."""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import check, generator, program
from perfbench.drive import Run, sync
from perfbench.reference import fit as ref_fit

ADAM_BETA1 = 0.9


def fit_state(start, lr, device):
    """The fit's parameters (leaf tensors from the start tables) and the
    fit's own Adam (``fit._adam``)."""
    from tputracer_torch import fit

    params = {k: torch.as_tensor(v, device=device).clone().requires_grad_()
              for k, v in start.items()}
    return params, fit._adam(list(params.values()), lr)


def first_gradient(params, opt):
    """Each parameter's gradient as the optimizer got it on its first
    step, from Adam's state: exp_avg = (1 - beta1) g."""
    return {k: opt.state[p]["exp_avg"] / (1.0 - ADAM_BETA1)
            for k, p in params.items()}


def fit_chain(scene, params, target, cfg, opt, n_steps):
    """``fit._fit_chain_single``: the (n_steps,) losses, on the device."""
    from tputracer_torch import fit

    return fit._fit_chain_single(scene, params, target, cfg, opt, n_steps)


class Kind(Run):
    kind = "fit"

    def setup(self):
        tr = self.traffic
        self.scene = self.build_scene()
        self.cfg = program.render_config(tr["render"], self.seed)
        t = time.perf_counter()
        with torch.no_grad():
            self.target = program.render(self.scene, self.cfg).clone()
        sync(self.device)
        self.host["target"] = [time.perf_counter() - t]
        t = time.perf_counter()
        self.start = generator.fit_start(self.arrays.materials, tr)
        self.params, self.opt = fit_state(self.start, tr["lr"], self.device)
        self.host["fit_state"] = [time.perf_counter() - t]
        self.steps_per_unit = tr["chain"]
        self.units = tr["traced_chains"]
        # the first chains, which warm up every shape, through the window's
        # own call and size; a hook reads the optimizer's state after the
        # first step
        grads = {}

        def after_first_step(opt, args, kwargs):
            hook.remove()
            grads.update(first_gradient(self.params, opt))

        hook = self.opt.register_step_post_hook(after_first_step)
        t = time.perf_counter()
        losses = []
        for _ in range(tr["checked_chains"]):
            losses += self.chain(self.steps_per_unit)
        hook.remove()
        self.prog = check.program_fit_numbers(losses, grads, self.params,
                                              self.start)
        self.host["checked_chains"] = [time.perf_counter() - t]

    def chain(self, n):
        return fit_chain(self.scene, self.params, self.target, self.cfg,
                         self.opt, n).tolist()

    def unit(self, u):
        self.chain(self.steps_per_unit)

    def window(self, seconds):
        steps, failed, times = 0, 0, []
        self.host["unit_s"] = times
        t0 = time.perf_counter()
        self.t_window = t0
        while True:
            t = time.perf_counter()
            losses = self.chain(self.steps_per_unit)
            times.append(time.perf_counter() - t)
            steps += len(losses)
            failed += sum(not np.isfinite(x) for x in losses)
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        return steps, failed, {"fit_steps_per_s": steps / elapsed}

    def free(self):
        self.scene = self.target = self.params = self.opt = None

    def checked_steps(self):
        return self.traffic["checked_chains"] * self.traffic["chain"]

    def reference(self, dtype, loss_of=ref_fit.mse):
        return ref_fit.first_steps(self.arrays, self.config, self.traffic,
                                   self.seed, self.device, dtype,
                                   self.checked_steps(), loss_of)

    def numbers(self):
        return check.fit_readings(self.prog, self.reference(torch.float32))

    def faults(self):
        """The bfloat16 control, and the reference's loss over every other
        image row (half the batch left out, the mean over the rest).  A
        state left unchanged reads 1 on change_gap and needs no run."""
        refr = self.reference(torch.float32)
        return {
            "control_bf16": check.fit_readings(
                self.reference(torch.bfloat16), refr),
            "fault_half_batch": check.fit_readings(
                self.reference(torch.float32, lambda img, t: ref_fit.mse(
                    img[::2], t[::2])), refr)}
