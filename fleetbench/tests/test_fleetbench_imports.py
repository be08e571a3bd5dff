"""Nothing the benchmark runs loads JAX or the JAX package (names compared
whole: the port's name begins with the JAX package's), and the reference
imports nothing of the program."""

import ast
import subprocess
import sys

from conftest import CHECKOUT

FORBIDDEN = {"jax", "jaxlib", "flax", "gpud_tpu"}
BENCH = CHECKOUT / "fleetbench"


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_sources_name_no_forbidden_module():
    files = [p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts]
    assert len(files) >= 15
    for path in files:
        assert not top_level_imports(path) & FORBIDDEN, path
    for path in (BENCH / "reference").rglob("*.py"):
        assert not top_level_imports(path) & ({"gpud_tpu_torch", "fleetbench", "torch"} | FORBIDDEN)


def test_a_run_loads_no_forbidden_module(tmp_path):
    """Everything a run loads, in a fresh interpreter: a traced run of a
    few hosts through the harness, the program on the CPU."""
    code = f"""
import sys, time, torch
sys.path.insert(0, {str(CHECKOUT)!r})
sys.path.insert(0, {str(BENCH / 'tests')!r})
import gpud_tpu_torch.fleet_scan as fs
fs._scan_devices = lambda _d: [torch.device("cpu")]
from conftest import cpu_run, small_cell
from fleetbench import harness, control
out = cpu_run(small_cell(hosts=3), {str(tmp_path)!r}, traced=True)
harness.read_metrics(harness.load_json(harness.CHECKOUT / "BENCHMARK.json")["per_layer"], out["run"])
assert out["correct"]
print(sorted(m for m in sys.modules if m.split(".")[0] in {sorted(FORBIDDEN)!r}))
print("gpud_tpu_torch.fleet_scan" in sys.modules)
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split() == ["[]", "True"]
