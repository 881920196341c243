"""Run one cell of the benchmark of ``tputracer_torch`` once.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks
for.  It builds the cell's scene from the seed, warms up every shape the
traffic uses (set-up), measures for ``--seconds``, with ``--trace 1``
then traces a short stretch, frees the program's state and compares what
the window produced with the plain reference.  Its last line on standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each number compared beside its limit; the same numbers are
the last lines on standard error.  It exits non-zero, printing no
result, without a CUDA card or enough of them, or if JAX or the JAX
package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# modules that must not be loaded, by their top-level name, compared whole
BARRED = ("jax", "jaxlib", "flax", "optax", "tputracer")


def barred_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(BARRED))


def set_environment(traffic):
    """The program's route switches as the traffic file sets them, every
    other one unset.  (The program's build caches, ``csrc/build`` and
    ``native/build``, sit at fixed paths inside the checkout.)"""
    for var in [v for v in os.environ if v.startswith("TPUTRACER_")]:
        del os.environ[var]
    os.environ.update({k: str(v) for k, v in traffic.get("env", {}).items()})


def power_limit():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    from perfbench import bench

    spec = bench.load(ROOT, args.workload)
    set_environment(spec.traffic)
    import torch

    from perfbench import drive

    t_imports = time.perf_counter() - T_START
    chips = spec.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.init()
    t_cuda = time.perf_counter() - T_START
    out = drive.run(spec, args.seed, args.seconds, bool(args.trace), device,
                    T_START)
    found = barred_modules()
    if found:
        print(f"perfbench: barred modules loaded: {found}", file=sys.stderr)
        return 3

    units = {m["name"]: m["unit"] for m in spec.end_to_end + spec.per_layer}
    if args.trace:
        values = {k: v for k, v in out["per_layer"].items() if v is not None}
    else:
        values = {m["name"]: out["e2e"][m["name"]] for m in spec.end_to_end}
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": chips, "memory_peak_bytes": int(out["peak"])}
    if args.trace:
        device_info.update(busy_s=out["busy_s"], window_s=out["window_s"])
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"],
              "metrics": {k: {"value": v, "unit": units[k]}
                          for k, v in values.items()},
              "device": device_info}
    if args.trace:
        result["breakdown"] = out["breakdown"]
    result["checks"] = out["checks"]
    print(f"perfbench: {args.workload} seed {args.seed} on {power_limit()}",
          file=sys.stderr)
    spans = dict(imports_done=t_imports, cuda_init_done=t_cuda, **out["host"])
    print("perfbench: set-up spans (s): " + json.dumps(spans),
          file=sys.stderr)
    print("perfbench: the window by 4 s: " + json.dumps(out["by_4s"]),
          file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
