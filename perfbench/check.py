"""The comparison that decides ``correct``: what the timed path produced
against the plain reference (``perfbench/reference``), number by number,
each against its limit from ``perfbench/cells/<cell>.json``.

Render cells compare the frames' images pixel by pixel, as the golden
test does (``tests/golden/test_pt_vs_oracle.py``): a channel's error
relative to 1 + |reference|; ``mean_rel`` is its mean over the compared
pixels and ``bad_share`` the share of channels above 5e-3.  The worst
frame counts.

Fit cells compare the first steps: ``loss_gap``, the largest relative gap
of a step's loss; ``grad_gap``, the gap between the norms of the first
gradient, program against reference, by the worst leaf, over the larger
of that leaf's reference norm and the median leaf's; ``change_gap``, the
same for the parameters' change after those steps.  Leaves whose
reference gradient is under a thousandth of the median leaf's are left
out of ``change_gap``: Adam moves them by rounding alone.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from perfbench.reference import pt as ref

BAD_REL = 5e-3
# pixels, drawn from the seed and then left out of the comparison, on
# which the emitter order is chosen (``emitter_orders``)
PROBE_PIXELS = 64


def image_numbers(prog, refp):
    """(P, 3) program pixels against (P, 3) reference pixels."""
    rel = np.abs(prog - refp) / (1.0 + np.abs(refp))
    return {"mean_rel": float(rel.mean()),
            "bad_share": float((rel > BAD_REL).mean())}


def judge(numbers, limits):
    """(correct, checks): every number at or under its limit; the checks
    as {name: {"value", "limit"}}."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return bool(ok), checks


def worst(readings):
    return {k: max(r[k] for r in readings) for k in readings[0]}


def pixel_sample(r, count, seed):
    """The pixel ids compared in each frame: all of them, or ``count``
    drawn from the seed."""
    n = r["width"] * r["height"]
    if not count or count >= n:
        return np.arange(n)
    return np.sort(np.random.default_rng([seed, 1]).choice(n, count,
                                                           replace=False))


def program_pixels(image, pixels, width):
    """The program's (H, W, 3) image (row 0 = top) at pixel ids counted
    from the bottom row, as the paths are numbered."""
    flat = np.ascontiguousarray(image[::-1]).reshape(-1, 3)
    return flat[pixels]


def emitter_orders(n):
    """The emitter orders the reference may take: the arrays' own, and its
    reverse.  ``make_scene`` keeps the emitters in the order of its
    triangle table, which its cluster BVH lays out; the reference does not
    rebuild that BVH, and on the mesh it reverses the light's two
    triangles."""
    ident = list(range(n))
    return [ident] if n < 2 else [ident, ident[::-1]]


def split_probe(pixels, seed):
    """(probe, judged): PROBE_PIXELS of ``pixels`` (a quarter, of fewer
    than four times that) drawn from the seed, on which the emitter order
    is chosen, and the rest, which are judged."""
    pixels = np.asarray(pixels)
    n = min(PROBE_PIXELS, len(pixels) // 4)
    if n < 1:
        raise ValueError(f"{len(pixels)} pixels are too few to split")
    pick = np.zeros(len(pixels), bool)
    pick[np.random.default_rng([seed, 3]).choice(
        len(pixels), n, replace=False)] = True
    return pixels[pick], pixels[~pick]


def render_readings(arrays, config, r, seed, frames, pixels, device,
                    emission_of, origin_of):
    """The numbers of each checked frame.

    frames: [(k, image)] of the program (or of a control), pixels: the
    compared pixel ids; emission_of(k) and origin_of(k) give frame k's
    emission table and camera origin, as the benchmark handed them to the
    program.  Where the scene has more than one emitter, the order is the
    one of :func:`emitter_orders` closer to the first frame on the probe
    pixels, and only the other pixels are judged."""

    def reference(k, order, ids):
        return reference_pixels(arrays, config, r, seed, emission_of(k),
                                origin_of(k), ids, device, torch.float32,
                                order)

    orders = emitter_orders(ref.n_emitters(arrays))
    order = orders[0]
    if len(orders) > 1:
        probe, pixels = split_probe(pixels, seed)
        k, img = frames[0]
        got = program_pixels(img, probe, r["width"])
        order = min(orders, key=lambda o: image_numbers(
            got, reference(k, o, probe))["mean_rel"])
    return [image_numbers(program_pixels(img, pixels, r["width"]),
                          reference(k, order, pixels))
            for k, img in frames]


def reference_pixels(arrays, config, r, seed, emission, origin, pixels,
                     device, dtype, order=None):
    """The reference's (P, 3) float32 pixels of one frame, computed in
    ``dtype``: float32, or bfloat16 for the control."""
    cam = config["camera"]
    sc = ref.make_ref_scene(
        arrays, eps=config["scene"]["eps"], device=device, dtype=dtype,
        emission=torch.as_tensor(emission, device=device), emit_order=order)
    c = ref.camera(origin, cam["look_at"], cam["up"], cam["vfov_deg"],
                   cam["aspect"], device, dtype)
    return ref.render_pixels(sc, c, torch.as_tensor(pixels, device=device),
                             r, seed).float().cpu().numpy()


def program_fit_numbers(losses, grads, params, start):
    """The program's first fit steps in the reference's form: its step
    losses, its first gradient's norm per table and its tables' change
    from the start tables."""
    return {"losses": [float(x) for x in losses],
            "grad": {k: float(torch.linalg.vector_norm(g.float()))
                     for k, g in grads.items()},
            "change": {k: float(torch.linalg.vector_norm(
                params[k].detach().float().cpu()
                - torch.as_tensor(np.asarray(start[k]))))
                for k in params}}


def fit_readings(prog, refr):
    """Numbers of the program's first fit steps against the reference's:
    each a dict of ``losses`` (list), ``grad`` and ``change`` (leaf name
    -> norm), and the reference's ``grad`` decides which leaves count."""
    loss_gap = max(abs(p - q) / abs(q)
                   for p, q in zip(prog["losses"], refr["losses"]))
    med_g = statistics.median(refr["grad"].values())
    counted = [k for k, v in refr["grad"].items() if v >= 1e-3 * med_g]

    def gap(key, leaves):
        med = statistics.median(refr[key][k] for k in leaves)
        return max(abs(prog[key][k] - refr[key][k])
                   / max(refr[key][k], med, 1e-30) for k in leaves)

    return {"loss_gap": loss_gap, "grad_gap": gap("grad", list(refr["grad"])),
            "change_gap": gap("change", counted)}
