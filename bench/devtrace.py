"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over the
window, reduced to what the per-layer metrics and the ``breakdown`` read.

The window is the host range ``bench.window``; the benchmark's own
``record_function`` ranges (``bench.pass``, ``bench.layer.<k>``, ...)
label what the host was doing in each device gap.  Device operations are
the trace's kernels, copies and sets; busy time is the length of their
union inside the window.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"
TOP = 10


def span(name: str):
    """A host range in the trace (a no-op where nothing is traced)."""
    import torch

    return torch.profiler.record_function(name)


class DeviceTrace:
    """``with DeviceTrace(enabled) as t:`` profiles the block on the card
    (CPU and CUDA activities); the profiler starts, and has traced one
    small kernel, before the block runs, so that its start-up stays out of
    the window.  The window is the block's ``with t.window():``;
    afterwards ``t.summary`` holds the reduction (``None`` when disabled)."""

    def __init__(self, enabled: bool) -> None:
        self.enabled = enabled
        self.summary: dict | None = None
        self._stack = contextlib.ExitStack()

    def __enter__(self) -> "DeviceTrace":
        if self.enabled:
            import torch
            from torch.profiler import ProfilerActivity, profile

            self._prof = self._stack.enter_context(
                profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            self._sync = torch.cuda.synchronize
        return self

    def window(self):
        """The measured window's host range (a no-op when disabled)."""
        return span(WINDOW) if self.enabled else contextlib.nullcontext()

    def __exit__(self, *exc) -> None:
        if not self.enabled:
            return
        try:
            self._sync()
        finally:
            self._stack.close()
        if exc[0] is None:
            fd, path = tempfile.mkstemp(suffix=".json", prefix="bench-trace-")
            os.close(fd)
            try:
                self._prof.export_chrome_trace(path)
                with open(path) as f:
                    events = json.load(f)
            finally:
                os.unlink(path)
            self.summary = reduce_events(events.get("traceEvents", events))


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return [(lo, hi) for lo, hi in merged]


def short_name(name: str) -> str:
    """A kernel's name without its return type and its argument list:
    ``void (anonymous namespace)::k<float, 2>(float const*, int)`` gives
    ``(anonymous namespace)::k<float, 2>``."""
    name = name.strip()
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i > 0 else name
                break
    if name.startswith("void "):
        name = name[5:]
    return name.strip()[:160]


def reduce_events(events: list[dict]) -> dict:
    """From Chrome-trace events (microseconds): ``window_s``, ``busy_s``,
    device seconds by operation name (``device_ops``), idle seconds by the
    innermost ``bench.`` host range open at each gap's start (``gaps``),
    and the ``bench.`` host ranges' counts and seconds (``ranges``)."""
    window = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"
              and e.get("cat") == "user_annotation"]
    if not window:
        raise ValueError("the trace holds no bench.window range")
    w_lo = float(window[0]["ts"])
    w_hi = w_lo + float(window[0]["dur"])
    ops: dict[str, float] = {}
    intervals = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        lo, hi = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        lo, hi = max(lo, w_lo), min(hi, w_hi)
        if hi <= lo:
            continue
        intervals.append((lo, hi))
        key = short_name(e.get("name", "?"))
        ops[key] = ops.get(key, 0.0) + (hi - lo) * 1e-6
    busy = _union(intervals)
    ranges = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                     for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                     and str(e.get("name", "")).startswith("bench.")),
                    key=lambda r: r[0])
    gaps: dict[str, float] = {}
    edge = w_lo
    for lo, hi in busy + [(w_hi, w_hi)]:
        if lo > edge:
            label = _innermost(ranges, edge)
            gaps[label] = gaps.get(label, 0.0) + (lo - edge) * 1e-6
        edge = max(edge, hi)
    counts: dict[str, list] = {}
    for lo, hi, name in ranges:
        c = counts.setdefault(name, [0, 0.0])
        c[0] += 1
        c[1] += (hi - lo) * 1e-6
    return {
        "window_s": (w_hi - w_lo) * 1e-6,
        "busy_s": sum(hi - lo for lo, hi in busy) * 1e-6,
        "device_ops": ops,
        "gaps": gaps,
        "ranges": {k: {"count": v[0], "seconds": v[1]} for k, v in counts.items()},
    }


def _innermost(ranges, t: float) -> str:
    best, width = WINDOW, float("inf")
    for lo, hi, name in ranges:
        if lo > t:
            break
        if hi >= t and hi - lo < width:
            best, width = name, hi - lo
    return best


def family_seconds(summary: dict, patterns) -> float:
    """Device seconds of the operations whose names hold any pattern."""
    return sum(s for name, s in summary["device_ops"].items()
               if any(p in name for p in patterns))


def breakdown(summary: dict) -> dict:
    """The ``breakdown`` of a result line: the ten device operations that
    took most time, and the ten host ranges with the most idle device time."""
    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {"device_ops": top(summary["device_ops"]), "idle_gaps": top(summary["gaps"])}
