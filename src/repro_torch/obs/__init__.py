"""Observability: on-device MoE metrics, engine span tracing, export."""
from .metrics import MetricsState, metrics_spec
from .tracing import SpanTracer
from . import tracing
from .export import (MetricsSnapshot, MetricsServer, parse_prometheus,
                     render_prometheus, snapshot_json_line)

__all__ = [
    "MetricsState", "metrics_spec",
    "SpanTracer", "tracing",
    "MetricsSnapshot", "MetricsServer", "render_prometheus",
    "parse_prometheus", "snapshot_json_line",
]
