"""Nothing of the benchmark loads JAX or the JAX package, and the
reference loads nothing of the program: each checked in a fresh
interpreter, by whole top-level module names (``repro_torch`` begins with
``repro``, so a prefix test would be wrong)."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts)
    for p in (ROOT / "port_bench").rglob("*.py")
    if "tests" not in p.parts and "layer_metrics" not in p.parts)


def _loaded(imports: list[str], paths: list[str]) -> set[str]:
    code = ("import json, sys\n"
            f"sys.path[:0] = {paths!r}\n"
            f"for m in {imports!r}: __import__(m)\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in "
            "sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, env={"PATH": "/usr/bin:/bin"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_no_module_of_the_benchmark_loads_jax_or_repro():
    assert "port_bench.run" in MODULES and "port_bench.harness" in MODULES
    program = ["repro_torch.core", "repro_torch.launch.serve",
               "repro_torch.kernels.ops"]
    top = _loaded(MODULES + program, [str(ROOT), str(ROOT / "src")])
    assert not top & {"jax", "jaxlib", "flax", "repro"}
    assert "repro_torch" in top          # the comparison is whole
    from port_bench import harness
    assert harness.forbidden_modules(["repro_torch.core", "numpy"]) == []
    assert harness.forbidden_modules(["repro.core", "jax._src"]) == [
        "jax", "repro"]


def test_the_reference_loads_nothing_of_the_program():
    top = _loaded(["port_bench.reference.anneal",
                   "port_bench.reference.threefry", "port_bench.counts"],
                  [str(ROOT)])
    assert not top & {"repro_torch", "repro", "jax", "jaxlib"}
