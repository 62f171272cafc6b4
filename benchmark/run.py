"""The benchmark of soundscope_tpu_torch: one run of one cell on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cells, their metrics and bounds are
in BENCHMARK.json; each cell's configuration, traffic and per-layer
readers are files under benchmark/ found by name (benchmark/harness.py).
The last line of standard output is one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics, or with --trace 1 its
per-layer ones), device, with --trace 1 breakdown, and last the compared
numbers beside their limits, which are also the last lines of standard
error. Without a CUDA card, with fewer cards than the cell asks for, or
with JAX, Flax or the JAX package loaded when the window has closed, it
prints no result and exits non-zero.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
# torch's own kernel cache, at a fixed place inside the checkout
KERNEL_CACHE = REPO / "build" / "benchmark" / "torch_kernels"
os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(KERNEL_CACHE)
# load from one process with few threads: the host's thread pools stay at one
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path.insert(0, str(REPO))


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="benchmark/run.py", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0,
                    help="1: profile a stretch and report the per-layer metrics")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    KERNEL_CACHE.mkdir(parents=True, exist_ok=True)
    import torch

    torch.set_num_threads(1)

    from benchmark import check, harness

    spec = harness.load_spec()
    chips = {w["name"]: w["chips"] for w in spec["workloads"]}.get(args.workload)
    if chips is None:
        print(f"error: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3
    line = harness.execute(args.workload, args.seed, args.seconds, bool(args.trace),
                           "cuda", T_START, spec=spec)
    bad = harness.forbidden_modules()
    if bad:
        print(f"error: loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 4
    check.print_checks(line["checks"])
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
