"""Trace/telemetry report: per-layer phase breakdown from a trace.json.

Loads a Chrome trace-event file exported by ``repro_torch.obs.trace.Tracer``
(plus, optionally, the matching telemetry snapshot from
``RunResult.telemetry``) and prints, per layer:

* the per-category busy-time breakdown (self time, so nested spans are
  not double-counted),
* overlap efficiency — how much offloaded work (read / spill / fsync /
  graduation / transform) ran concurrently with the delivery thread,
  and the pipeline bubble % (delivery-thread stalls / layer wall),
* the dominant bottleneck category.

``--check`` validates the trace-event schema (well-formed ``ph``/``ts``/
``tid`` fields, strictly nested B/E pairs per thread) and exits non-zero
on violations.  When telemetry is given, ``--check`` also reconciles
span category totals against the ``LayerMetrics`` scalar fields.  Pure
JSON analysis: the trace files and telemetry of either package read the
same.

Usage::

    python -m repro_torch.launch.obs_report trace.json
    python -m repro_torch.launch.obs_report trace.json --telemetry bench.json \
        --check --json report.json
"""

from __future__ import annotations

import argparse
import json
import sys

# phases whose spans run on offload threads — work the pipeline design
# tries to hide behind delivery (vs. inline main-thread categories)
OFFLOADED_CATS = ("read", "spill", "fsync", "barrier", "drain", "sink")

# LayerMetrics field <- trace categories it should reconcile with
# (self-time totals; a parent category lists the children carved out of
# it so parent_self + children == the scalar's timed region)
RECONCILE = {
    "aggregate_seconds": ("aggregate", "h2d"),
    "h2d_seconds": ("h2d",),
    "pipeline_stall_seconds": ("stall",),
    "transform_seconds": ("transform",),
    "barrier_seconds": ("barrier", "fsync"),
}


# --------------------------------------------------------------------------
# Loading + schema validation
# --------------------------------------------------------------------------


def load_trace(path: str) -> list[dict]:
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict):
        events = data.get("traceEvents")
        if not isinstance(events, list):
            raise ValueError(f"{path}: no traceEvents array")
        return events
    if isinstance(data, list):  # the bare-array trace-event variant
        return data
    raise ValueError(f"{path}: not a trace-event JSON object or array")


def validate_trace(events: list[dict]) -> list[str]:
    """Schema violations in a trace-event list (empty == valid).

    Checks the subset the exporter promises: known ``ph`` values,
    numeric non-negative ``ts`` with ``pid``/``tid`` on all timed
    events, names on B/E pairs, and strict B/E nesting per
    ``(pid, tid)`` track — every E matches the innermost open B and no
    B is left open at the end."""
    violations: list[str] = []
    stacks: dict[tuple, list[tuple[str, float]]] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            violations.append(f"event[{i}]: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("B", "E", "X", "M", "C", "I", "i"):
            violations.append(f"event[{i}]: unknown ph {ph!r}")
            continue
        if ph == "M":
            continue  # metadata events carry no timestamp
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            violations.append(f"event[{i}]: bad ts {ts!r}")
            continue
        if "tid" not in ev or "pid" not in ev:
            violations.append(f"event[{i}]: missing pid/tid")
            continue
        if ph in ("B", "E"):
            name = ev.get("name")
            if not name:
                violations.append(f"event[{i}]: {ph} event without name")
                continue
            stack = stacks.setdefault((ev["pid"], ev["tid"]), [])
            if ph == "B":
                if stack and ts < stack[-1][1]:
                    violations.append(
                        f"event[{i}]: B {name!r} ts precedes open parent"
                    )
                stack.append((name, ts))
            else:
                if not stack:
                    violations.append(
                        f"event[{i}]: E {name!r} with no open span on "
                        f"tid {ev['tid']}"
                    )
                elif stack[-1][0] != name:
                    violations.append(
                        f"event[{i}]: E {name!r} does not match open "
                        f"B {stack[-1][0]!r} (improper nesting)"
                    )
                    stack.pop()
                else:
                    stack.pop()
    for (pid, tid), stack in stacks.items():
        for name, _ in stack:
            violations.append(
                f"tid {tid}: B {name!r} never closed (unbalanced B/E)"
            )
    return violations


# --------------------------------------------------------------------------
# Span extraction + per-layer analysis
# --------------------------------------------------------------------------


def extract_spans(events: list[dict]) -> tuple[list[dict], dict[int, str]]:
    """Matched spans (with self time) + tid -> thread-name map."""
    names: dict[int, str] = {}
    spans: list[dict] = []
    stacks: dict[tuple, list[list]] = {}
    for ev in events:
        ph = ev.get("ph")
        if ph == "M":
            if ev.get("name") == "thread_name":
                names[ev.get("tid")] = ev.get("args", {}).get("name", "?")
            continue
        if ph not in ("B", "E"):
            continue
        key = (ev.get("pid"), ev.get("tid"))
        stack = stacks.setdefault(key, [])
        if ph == "B":
            stack.append([ev["name"], ev.get("cat", "?"), ev["ts"], 0.0])
        elif stack and stack[-1][0] == ev["name"]:
            name, cat, ts0, child = stack.pop()
            dur = ev["ts"] - ts0
            if stack:
                stack[-1][3] += dur
            spans.append({
                "tid": ev.get("tid"), "name": name, "cat": cat,
                "start_us": ts0, "dur_us": dur,
                "self_us": max(0.0, dur - child),
            })
    return spans, names


def analyze(events: list[dict]) -> dict:
    """Per-layer phase breakdown, overlap efficiency, and bottleneck."""
    spans, names = extract_spans(events)
    layer_spans = sorted(
        (s for s in spans if s["cat"] == "layer"),
        key=lambda s: s["start_us"],
    )
    layers = []
    for ls in layer_spans:
        t0, t1 = ls["start_us"], ls["start_us"] + ls["dur_us"]
        wall_s = ls["dur_us"] / 1e6
        cats: dict[str, float] = {}
        # a span belongs to the layer whose window its B falls in; the
        # deferred barrier (helper thread) may end after the window, so
        # bucketing by begin keeps it with the layer that began it
        for s in spans:
            if s["cat"] == "layer" or not (t0 <= s["start_us"] < t1):
                continue
            cats[s["cat"]] = cats.get(s["cat"], 0.0) + s["self_us"] / 1e6
        offloaded = sum(cats.get(c, 0.0) for c in OFFLOADED_CATS)
        stall = cats.get("stall", 0.0)
        dominant = max(cats, key=cats.get) if cats else None
        layers.append({
            "name": ls["name"],
            "wall_seconds": wall_s,
            "category_seconds": dict(sorted(cats.items())),
            "offloaded_seconds": offloaded,
            # offloaded busy time per second of layer wall: >0 means the
            # pipeline hid that much work behind delivery; can exceed 1
            # with several busy offload threads
            "overlap_ratio": offloaded / wall_s if wall_s else 0.0,
            "bubble_pct": 100.0 * stall / wall_s if wall_s else 0.0,
            "dominant": dominant,
        })
    total_cats: dict[str, float] = {}
    for s in spans:
        total_cats[s["cat"]] = total_cats.get(s["cat"], 0.0) + s["self_us"] / 1e6
    return {
        "num_events": len(events),
        "num_spans": len(spans),
        "threads": {str(t): n for t, n in sorted(names.items())},
        "layers": layers,
        "category_seconds": dict(sorted(total_cats.items())),
    }


def reconcile(report: dict, layer_metrics: list[dict],
              tolerance: float = 0.05, floor_s: float = 0.005) -> list[str]:
    """Cross-check span category totals against LayerMetrics scalars.

    Compares run totals (summed over layers), not per-layer values — the
    deferred barrier's span lands in the next layer's window.  Values
    below ``floor_s`` are skipped: at sub-5ms scale, span-begin/end
    overhead and clock jitter dominate the comparison."""
    problems: list[str] = []
    trace_cats = report["category_seconds"]
    for field, cats in RECONCILE.items():
        metric = sum(float(m.get(field, 0.0)) for m in layer_metrics)
        traced = sum(trace_cats.get(c, 0.0) for c in cats)
        if metric < floor_s and traced < floor_s:
            continue
        ref = max(metric, floor_s)
        if abs(traced - metric) / ref > tolerance:
            problems.append(
                f"{field}: metrics say {metric:.4f}s, trace "
                f"({'+'.join(cats)}) says {traced:.4f}s "
                f"(>{tolerance:.0%} apart)"
            )
    return problems


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------


def _fmt_seconds(s: float) -> str:
    return f"{s * 1e3:8.2f}ms" if s < 1.0 else f"{s:8.3f}s "


def print_report(report: dict, out=sys.stdout) -> None:
    p = lambda *a: print(*a, file=out)  # noqa: E731
    p(f"trace: {report['num_events']} events, {report['num_spans']} spans, "
      f"{len(report['threads'])} thread tracks")
    for tid, name in report["threads"].items():
        p(f"  tid {tid:>4}: {name}")
    for layer in report["layers"]:
        p(f"\n{layer['name']}  wall {_fmt_seconds(layer['wall_seconds'])}"
          f"  overlap {layer['overlap_ratio']:.2f}x"
          f"  bubble {layer['bubble_pct']:.1f}%"
          f"  bottleneck: {layer['dominant']}")
        for cat, sec in sorted(
            layer["category_seconds"].items(), key=lambda kv: -kv[1]
        ):
            share = sec / layer["wall_seconds"] if layer["wall_seconds"] else 0
            p(f"    {cat:<10} {_fmt_seconds(sec)}  {share:6.1%} of wall")
    if not report["layers"]:
        p("\n(no layer spans — run totals only)")
        for cat, sec in sorted(
            report["category_seconds"].items(), key=lambda kv: -kv[1]
        ):
            p(f"    {cat:<10} {_fmt_seconds(sec)}")


def _load_layer_metrics(path: str) -> list[dict]:
    """LayerMetrics dicts from a telemetry snapshot or bench JSON: the
    first ``layers`` list of LayerMetrics-shaped dicts found anywhere in
    the document (``RunResult.telemetry`` nests it at the top;
    bench_delivery JSON nests it under ``traced.telemetry``)."""
    with open(path) as f:
        data = json.load(f)

    def find(node):
        if isinstance(node, list):
            if node and all(
                isinstance(m, dict) and "aggregate_seconds" in m for m in node
            ):
                return node
            for v in node:
                got = find(v)
                if got:
                    return got
        elif isinstance(node, dict):
            got = find(node.get("layers"))
            if got:
                return got
            for v in node.values():
                got = find(v)
                if got:
                    return got
        return None

    return find(data) or []


def _find_cache_counters(path: str) -> list[dict]:
    """Serving page-cache counter dicts from a telemetry/bench JSON: any
    ``serve.cache`` registry subtree (MetricsRegistry snapshot) or
    ``cache_counters`` record (bench_serve rows), wherever it nests."""
    with open(path) as f:
        data = json.load(f)
    found: list[dict] = []

    def walk(node):
        if isinstance(node, dict):
            cache = node.get("serve", {})
            if isinstance(cache, dict) and isinstance(
                cache.get("cache"), dict
            ):
                found.append(cache["cache"])
            if isinstance(node.get("cache_counters"), dict):
                found.append(node["cache_counters"])
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)

    walk(data)
    return found


def _print_cache_counters(counters: list[dict], out=sys.stdout) -> None:
    p = lambda *a: print(*a, file=out)  # noqa: E731
    p(f"\nserve cache ({len(counters)} reader(s)):")
    for i, c in enumerate(counters):
        hits = float(c.get("hits", 0))
        misses = float(c.get("misses", 0))
        total = hits + misses
        rb = c.get("resident_bytes", {})
        resident = rb.get("value", 0.0) if isinstance(rb, dict) else rb
        p(f"  [{i}] hits={int(hits)} misses={int(misses)} "
          f"hit_rate={hits / total if total else 0.0:.4f} "
          f"evicted={int(float(c.get('evicted_blocks', 0)))} "
          f"resident={float(resident) / (1 << 20):.2f}MiB")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="Per-layer phase breakdown from an ATLAS trace.json"
    )
    ap.add_argument("trace", help="Chrome trace-event JSON (Tracer.export)")
    ap.add_argument("--telemetry", default=None,
                    help="RunResult.telemetry / bench JSON to reconcile "
                         "LayerMetrics against span totals")
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero on schema violations (and, with "
                         "--telemetry, metric reconciliation failures)")
    ap.add_argument("--tolerance", type=float, default=0.05,
                    help="reconciliation tolerance (default 0.05 = 5%%)")
    ap.add_argument("--json", default=None,
                    help="also write the report as JSON to this path")
    args = ap.parse_args(argv)

    events = load_trace(args.trace)
    violations = validate_trace(events)
    report = analyze(events)
    print_report(report)

    problems = list(violations)
    if violations:
        print(f"\nSCHEMA: {len(violations)} violation(s)", file=sys.stderr)
        for v in violations[:20]:
            print(f"  {v}", file=sys.stderr)
    if args.telemetry:
        cache_counters = _find_cache_counters(args.telemetry)
        if cache_counters:
            _print_cache_counters(cache_counters)
            report["serve_cache"] = cache_counters
        layer_metrics = _load_layer_metrics(args.telemetry)
        if not layer_metrics:
            print(f"\nwarning: no LayerMetrics found in {args.telemetry}; "
                  "skipping reconciliation", file=sys.stderr)
        mismatches = reconcile(
            report, layer_metrics, tolerance=args.tolerance,
        ) if layer_metrics else []
        problems += mismatches
        if mismatches:
            print(f"\nRECONCILE: {len(mismatches)} mismatch(es)",
                  file=sys.stderr)
            for m in mismatches:
                print(f"  {m}", file=sys.stderr)
        else:
            print("\nreconcile: span totals match LayerMetrics "
                  f"(±{args.tolerance:.0%})")
    if args.json:
        report["violations"] = problems
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
    if args.check and problems:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
