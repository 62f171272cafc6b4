"""The readings that a cell's limits are set from, in one process on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 12 --control-seeds 3 \
        [--first-seed N] [--seconds 3] [--control-seconds 1]

Runs the cell's timed path through a short window on each of `--seeds`
seeds (the program: the lower readings), then the control, the reference
in bfloat16 put in the program's place, on `--control-seeds` further seeds
(the upper readings), each at the cell's own sizes. Prints one JSON line
per run and, last, for each compared number the largest program reading
and the smallest control reading. The limits themselves are set by hand
from these, in benchmark/limits/<cell>.json.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/calibrate.py", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control-seconds", type=float, default=1.0)
    ap.add_argument("--also", type=int, nargs="*", default=[],
                    help="further seeds of the program (earlier runs' seeds)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)

    import torch

    from benchmark import harness, systems

    if not torch.cuda.is_available():
        print("error: no CUDA card", file=sys.stderr)
        return 3
    lower, upper = {}, {}
    runs = [(systems.Program(), args.first_seed + i) for i in range(args.seeds)]
    runs += [(systems.Program(), s) for s in args.also]
    runs += [(systems.Control(), args.first_seed + 1000 + i) for i in range(args.control_seeds)]
    for system, seed in runs:
        control = system.name == "control"
        # the control's steps take seconds each: no warm-up, one step or a few
        over = {"traffic": {"warmup_steps": 0}} if control else None
        t = time.perf_counter()
        line = harness.execute(args.workload, seed,
                               args.control_seconds if control else args.seconds, False,
                               "cuda", T_START, system=system, overrides=over)
        vals = {k: v["value"] for k, v in line["checks"].items()}
        print(json.dumps({"system": system.name, "seed": seed, "correct": line["correct"],
                          "attempted": line["attempted"], "seconds": time.perf_counter() - t,
                          "checks": vals}), flush=True)
        for k, v in vals.items():
            if control:
                upper[k] = min(upper.get(k, float("inf")), v)
            else:
                lower[k] = max(lower.get(k, 0.0), v)
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
