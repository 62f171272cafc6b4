"""One run of one cell: resolve the cell's files by name, drive it, judge
what it produced, and build the result's line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name BENCHMARK.json gives it:

    benchmark/configs/<config>.json      the configuration as it is run
    benchmark/traffic/<traffic>.json     the mix: its driver and parameters
    benchmark/metrics/<metric>.py        a reader: read(reading) -> value | None
    benchmark/limits/<cell>.json         the limit of each compared number
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path

import torch

from benchmark import check, drivers, systems

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "soundscope_tpu")


def load_spec(path: Path = ROOT.parent / "BENCHMARK.json") -> dict:
    with open(path) as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(spec: dict, cell: str, root: Path = ROOT) -> dict:
    """The cell's entry, configuration, traffic, limits and metrics, from
    the files under `root` (the benchmark's folder)."""
    work = {w["name"]: w for w in spec["workloads"]}
    if cell not in work:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    w = work[cell]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    return {
        "workload": w,
        "config": _json(root.parent / conf["file"]),
        "traffic": _json(root / "traffic" / f"{w['traffic']}.json"),
        "limits": check.load_limits(root, cell),
        "end_to_end": [m for m in spec["end_to_end"] if applies(m, cell)],
        "per_layer": [m for m in spec["per_layer"] if applies(m, cell)],
    }


def reader(name: str, root: Path = ROOT):
    """The module <root>/metrics/<name>.py (names hold dots)."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def _finite(v):
    if v is None:
        return None
    return v if math.isfinite(v) else (sys.float_info.max if v > 0 else -sys.float_info.max)


def execute(cell: str, seed: int, seconds: float, trace: bool, device, t_start: float,
            system=None, overrides: dict | None = None, spec: dict | None = None,
            root: Path = ROOT) -> dict:
    """Run `cell` once; returns the result's line as a dict. `overrides`
    ({"config": {...}, "traffic": {...}}) replace keys of the cell's files
    (tests run tiny shapes so)."""
    c = resolve(spec or load_spec(), cell, root)
    for k in ("config", "traffic"):
        c[k].update((overrides or {}).get(k, {}))
    dev = torch.device(device)
    ctx = drivers.Ctx(config=c["config"], traffic=c["traffic"], seed=seed,
                      seconds=seconds, trace=trace, device=dev,
                      system=system or systems.Program(),
                      t_start=t_start, kernels=_json(root / "metrics" / "kernels.json"),
                      limits=c["limits"])
    run = drivers.DRIVERS[c["traffic"]["driver"]](ctx)

    metrics = {}
    if not trace:
        for m in c["end_to_end"]:
            v = run.setup_s if m["name"] == "setup_s" else run.e2e[m["name"]]
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    elif run.reading is not None:
        for m in c["per_layer"]:
            v = reader(m["name"], root).read(run.reading)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    ok, checks = run.numbers.verdict(c["limits"]["limits"])
    for v in checks.values():
        v["value"] = _finite(v["value"])
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": run.memory_peak_bytes}
    line = {"correct": bool(ok and run.attempted > 0 and run.failed == 0),
            "attempted": run.attempted, "failed": run.failed, "metrics": metrics,
            "device": device_info}
    if trace and run.reading is not None:
        device_info["busy_s"] = run.reading.busy_us() / 1e6
        device_info["window_s"] = run.reading.window_us / 1e6
        line["breakdown"] = {"device_ops": run.reading.top_ops(),
                             "idle_gaps": run.reading.idle_gaps()}
    line["checks"] = checks
    return line
