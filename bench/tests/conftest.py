"""Puts the program (``src/``) on the path and gives the tests a small
copy of the benchmark whose traffic is cut to a size the CPU runs in
seconds."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

SMALL_VERTICES = 3000


def small_copy(dest: Path, vertices: int = SMALL_VERTICES) -> Path:
    """``BENCHMARK.json`` and ``bench/`` copied under ``dest`` with every
    traffic's graph cut to ``vertices``."""
    shutil.copytree(ROOT / "bench", dest / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    for f in (dest / "bench" / "workloads").glob("*.json"):
        t = json.loads(f.read_text())
        t["graph"]["num_vertices"] = vertices
        f.write_text(json.dumps(t))
    return dest


@pytest.fixture
def small_root(tmp_path) -> Path:
    return small_copy(tmp_path / "root")


def run_cell(root: Path, cell: str, capsys, *, seed: int = 4294967311, seconds: float = 0.3,
             trace: int = 0) -> tuple[int, dict | None]:
    """``harness.main`` on the CPU; ``(exit code, the result line or None)``."""
    from bench import harness
    from bench.window import clock

    capsys.readouterr()
    rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], root=root, t0=clock(), device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 and lines else None)
