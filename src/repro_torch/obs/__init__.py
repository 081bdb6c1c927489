"""Unified run telemetry: span tracing, metrics, resource sampling.

- :mod:`repro_torch.obs.trace` — thread-tracked spans, Perfetto-loadable
  Chrome trace-event export, zero-cost :data:`NULL_TRACER` default.
- :mod:`repro_torch.obs.metrics` — counters / gauges / log-bucket latency
  histograms behind one ``snapshot()`` tree.
- :mod:`repro_torch.obs.sampler` — background RSS + disk-byte sampler.

Enable per-run via ``AtlasConfig(trace=True)`` or
``AtlasSession(..., trace=True)``.
"""

from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .sampler import ResourceSampler
from .trace import CATEGORIES, NULL_TRACER, NullTracer, Tracer, as_tracer

__all__ = [
    "CATEGORIES",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_TRACER",
    "NullTracer",
    "ResourceSampler",
    "Tracer",
    "as_tracer",
]
