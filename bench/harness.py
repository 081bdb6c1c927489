"""The harness: finds a cell's files by the names in ``BENCHMARK.json``,
runs its path once, reads its metrics and prints the result line.

Driven by data.  For a cell it reads ``BENCHMARK.json``'s entry, then:

- the configuration's ``file`` (``bench/configs/<name>.json``);
- the traffic ``bench/workloads/<traffic>.json``, whose ``path`` names
  the module ``bench/paths/<path>.py`` that drives the program;
- the limits of the numbers compared, ``bench/checks/<cell>.json``;
- for each metric the cell reports, the reader
  ``bench/metrics/<metric>.py`` (``read(ctx) -> float | None``).

A new configuration, traffic, path or metric is a new file and a new
entry in ``BENCHMARK.json``; no file here changes.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class RunSpec:
    """What a path gets: the cell's data and the run's arguments."""

    cell: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float  # host clock at process start
    cache_dir: Path  # the checkout's cache of what the benchmark generates (``build/bench``)


def parse_args(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="length of the window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module from its file (names may hold ``.`` or ``-``)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location("bench_file_" + re.sub(r"\W", "_", str(path)),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """A cell of ``BENCHMARK.json`` with every file it names, loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    path: Path  # the path module's file
    metrics: dict  # metric name -> its BENCHMARK.json entry, the ones this run reports
    readers: dict  # metric name -> reader file


def metrics_of(bench: dict, cell: str, trace: bool) -> dict:
    """The metrics a run of ``cell`` reports: the end-to-end ones untraced,
    the per-layer ones traced.  A metric is in the cells its ``workloads``
    list; one that lists none is in every cell (``setup_s``), a per-layer
    one in every cell that reports the end-to-end metric it ``moves``."""
    e2e = {m["name"]: m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])}
    if not trace:
        return e2e
    return {m["name"]: m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in e2e else [])}


def find_cell(root: Path, name: str, trace: bool) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json (cells: {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(root / "bench" / "workloads" / f"{w['traffic']}.json")
    limits = load_json(root / "bench" / "checks" / f"{name}.json")
    metrics = metrics_of(bench, name, trace)
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                limits=limits, path=root / "bench" / "paths" / f"{traffic['path']}.py",
                metrics=metrics,
                readers={m: root / "bench" / "metrics" / f"{m}.py" for m in metrics})


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that are JAX or its package,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


def judge(values: dict, limits: dict) -> dict:
    """Each number compared beside its limit.  A number ``<name>.<which>``
    takes the limit of ``<name>``."""
    out = {}
    for key, value in values.items():
        limit = limits[key.split(".")[0]]["limit"]
        out[key] = {"value": value, "limit": limit,
                    "ok": bool(math.isfinite(value) and value <= limit)}
    return out


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=30)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi not read: {e}"


def device_info(dev, peak: int) -> dict:
    """The result line's ``device``: the card's name, one card, its peak."""
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": int(peak)}
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
            "memory_peak_bytes": int(peak)}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv, *, root: Path = ROOT, t0: float, device: str = "cuda") -> int:
    """One run of one cell; the result line is the last line on stdout.
    ``device="cpu"`` skips the look for a card (the CPU tests)."""
    args = parse_args(argv)
    cell = find_cell(root, args.workload, bool(args.trace))
    if device == "cuda":
        import torch

        t_torch = time.perf_counter() - t0
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell.chips:
            log(f"cell {cell.name} needs {cell.chips} CUDA device(s); "
                f"torch.cuda.is_available()={torch.cuda.is_available()}, count {have}")
            return 2
        log(f"[harness] torch imported {t_torch:.3f} s and {have} card(s) found "
            f"{time.perf_counter() - t0:.3f} s after process start")
    spec = RunSpec(cell=cell.name, config=cell.config, traffic=cell.traffic, seed=args.seed,
                   seconds=args.seconds, trace=bool(args.trace), device=device, t0=t0,
                   cache_dir=root / "build" / "bench")
    path = load_module(cell.path)
    run = path.run(spec)
    if device == "cuda":
        log(f"card: {card_line()}")
    ctx = run["ctx"]
    metrics = {}
    for name, entry in cell.metrics.items():
        value = load_module(cell.readers[name]).read(ctx)
        if value is None:
            if not args.trace:
                log(f"end-to-end metric {name} read nothing in cell {cell.name}")
                return 4
            continue
        metrics[name] = {"value": float(value), "unit": entry["unit"]}
    checks = judge(run["checks"], cell.limits)
    failed = sum(not c["ok"] for c in checks.values())
    device_info = dict(run["device"])
    if args.trace:
        summary = ctx["trace"]
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
    result = {"correct": bool(checks) and failed == 0,
              "attempted": run["attempted"], "failed": failed,
              "metrics": metrics, "device": device_info}
    if args.trace:
        from bench.devtrace import breakdown

        result["breakdown"] = breakdown(ctx["trace"])
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    for k, c in checks.items():
        log(f"check {k}: {c['value']!r} (limit {c['limit']!r}) {'ok' if c['ok'] else 'FAILED'}")
    # Last, once the path, every reader and the trace's reduction have run.
    found = forbidden_modules()
    if found:
        log(f"the run loaded {found}: the benchmark measures repro_torch alone")
        return 3
    print(json.dumps(result), flush=True)
    return 0
