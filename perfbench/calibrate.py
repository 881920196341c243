"""The readings that the limits of ``correct`` are set from, for one cell:

    python3 perfbench/calibrate.py --workload <name> --seeds 12
        --base 90001 --controls 3 --seconds 2 --out calibrate_<name>.json

In one process, on the card, at the cell's own sizes:

  * the program's numbers on ``--seeds`` seeds, each a run with a short
    window (the lower readings);
  * on the first ``--controls`` of them, the numbers of the control (the
    reference computed in bfloat16, the precision below the float32 that
    the configurations state, put in the program's place) and of the
    faults that the traffic kind plants (its ``faults()``).

It prints one JSON object and writes it to ``--out``.  The benchmark's
own runs never run it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def seeds_of(base, n):
    """n seeds from ``base``, every other one past 2^31."""
    return [base + 7919 * i + (1 << 31) * (i % 2) for i in range(n)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--base", type=int, default=90001,
                    help="the seeds are drawn from this number")
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from perfbench import bench
    from perfbench.run import power_limit, set_environment

    spec = bench.load(ROOT, args.workload)
    set_environment(spec.traffic)
    device = torch.device("cuda", 0)
    res = {"workload": args.workload, "card": power_limit(), "runs": []}
    for i, seed in enumerate(seeds_of(args.base, args.seeds)):
        drv = spec.kind(spec, seed, device)
        drv.setup()
        drv.calibration_window(args.seconds)
        drv.peak()
        drv.release()
        t1 = time.perf_counter()
        row = {"seed": seed, "program": drv.numbers(),
               "check_s": time.perf_counter() - t1}
        if i < args.controls:
            row.update(drv.faults())
        res["runs"].append(row)
        print(json.dumps(row), file=sys.stderr, flush=True)
    res["seconds"] = time.perf_counter() - T_START
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
