"""No file of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program; a run without a card, or
without the program, prints no result."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest

from bench import harness

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported_top_names(path: Path) -> set[str]:
    """Top-level names of every absolute import in a file, whole."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_the_walk_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.dist\nfrom repro.core import atlas\nimport jaxlib as j\n")
    assert imported_top_names(f) == {"repro_torch", "repro", "jaxlib"}


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_benchmark_file_imports_jax_or_its_package(path):
    assert not imported_top_names(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert imported_top_names(path) <= {"__future__", "contextlib", "torch", "numpy", "math"}


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("repro.core"))
    assert harness.forbidden_modules() == ["repro"]


def test_a_reader_that_loads_the_jax_package_stops_the_result(tmp_path, capsys, monkeypatch):
    """The look at ``sys.modules`` comes after every reader has run."""
    from bench.tests.conftest import small_copy
    from bench.tests.test_bench_harness import add_toy_cell
    from bench.window import clock

    monkeypatch.delitem(sys.modules, "repro", raising=False)  # restored afterwards
    root = small_copy(tmp_path / "root")
    add_toy_cell(root)
    (root / "bench" / "metrics" / "toy.width.py").write_text(
        "import sys, types\n\n\ndef read(ctx):\n"
        "    sys.modules['repro'] = types.ModuleType('repro')\n    return 1.0\n")
    argv = ["--workload", "toy-cell", "--seed", "7", "--seconds", "0.3", "--trace", "1"]
    capsys.readouterr()
    try:
        rc = harness.main(argv, root=root, t0=clock(), device="cpu")
    finally:
        sys.modules.pop("repro", None)
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "['repro']" in err


def _run(cwd: Path, script: Path) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, str(script), "--workload", "gcn-hbm", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_a_run_without_a_card_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal on a host without one")
    r = _run(ROOT, BENCH / "run.py")
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_a_run_without_the_program_prints_no_result(tmp_path):
    import shutil

    shutil.copytree(BENCH, tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    r = _run(tmp_path, tmp_path / "bench" / "run.py")
    assert r.returncode != 0 and r.stdout.strip() == ""
