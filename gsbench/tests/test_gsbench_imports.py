"""The harness loads neither JAX nor the JAX package ``repro``, and the plain
reference loads nothing of the program."""
import ast
import json
import subprocess
import sys

import pytest

from gsbench.harness import BENCH, ROOT, load_spec

SPEC = load_spec()
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

# Imports every module one cell's run loads (the harness, the cell's
# readers, the program's entry points it drives), then prints the
# top-level names of sys.modules.
PROBE = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
import torch
from gsbench import cell, check, devtrace, drive, harness, work
from gsbench.reference import render
from gsbench.tools import capacity_pass, readings, serve_sweep, spread
parts = harness.resolve(harness.load_spec(), {cell!r})
import repro_torch.engine, repro_torch.serving.server, repro_torch.engine.stream
import repro_torch.kernels.build, repro_torch.core.pipeline, repro_torch.obs
import runpy
runpy.run_path({run!r}, run_name="gsbench_run")
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def top_level_names(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_a_cells_modules_load_no_jax_and_not_the_jax_package(cell):
    names = top_level_names(PROBE.format(root=str(ROOT), src=str(ROOT / "src"), cell=cell,
                                         run=str(BENCH / "run.py")))
    assert "repro_torch" in names and "gsbench" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_the_check_compares_whole_top_level_names(monkeypatch):
    import runpy

    run = runpy.run_path(str(BENCH / "run.py"), run_name="gsbench_run")
    modules = dict(sys.modules)
    for name in [m for m in modules if m.split(".", 1)[0] in FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro_torch_extra.x", object())
    assert run["forbidden_modules"]() == []
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert run["forbidden_modules"]() == ["repro"]


def imported_roots(path) -> set:
    tree = ast.parse(path.read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".", 1)[0])
    return roots


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert not imported_roots(path) & (FORBIDDEN | {"repro_torch"}), path
    names = top_level_names(
        f"import json, sys\nsys.path[:0] = [{str(ROOT)!r}]\n"
        "import gsbench.reference.render\n"
        "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))")
    assert not names & (FORBIDDEN | {"repro_torch"})


def test_no_harness_file_reads_the_old_benchmarks_folder():
    for path in BENCH.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        assert "benchmarks" not in imported_roots(path), path
        assert "benchmarks/" not in path.read_text(), path
