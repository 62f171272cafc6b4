"""Nothing of the benchmark loads JAX, Flax or the JAX package, and the
reference loads nothing of the program under test."""

import json
import subprocess
import sys

from benchmark.tests.conftest import REPO

PROBE = r"""
import importlib, importlib.util, json, pkgutil, sys
from pathlib import Path
root = Path(sys.argv[1])
sys.path.insert(0, str(root.parent))
mods = []
for p in sorted(root.rglob("*.py")):
    rel = p.relative_to(root.parent).with_suffix("")
    if p.parent.name == "metrics" and p.parent.parent == root and sys.argv[2] == "benchmark":
        spec = importlib.util.spec_from_file_location("m_" + p.stem.replace(".", "_"), p)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
    elif sys.argv[2] in str(rel).replace("/", ".") and p.name != "conftest.py":
        importlib.import_module(".".join(rel.parts).removesuffix(".__init__"))
    mods.append(str(rel))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def loaded_top_names(prefix: str) -> set:
    p = subprocess.run([sys.executable, "-c", PROBE, str(REPO / "benchmark"), prefix],
                       capture_output=True, text=True, timeout=300, cwd=REPO)
    assert p.returncode == 0, p.stderr
    return set(json.loads(p.stdout.splitlines()[-1]))


def test_benchmark_loads_no_jax():
    names = loaded_top_names("benchmark")
    assert "benchmark" in names
    assert not names & {"jax", "jaxlib", "flax", "soundscope_tpu"}


def test_reference_loads_nothing_of_the_program():
    names = loaded_top_names("benchmark.reference")
    assert "benchmark" in names
    assert not names & {"soundscope_tpu_torch", "jax", "jaxlib", "flax", "soundscope_tpu"}
