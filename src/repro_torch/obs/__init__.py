"""repro_torch.obs -- run-wide span tracing, Perfetto export, critical-path
analysis, and the failure flight recorder.

Opt in per run (``tracing: {...}`` in the workflow YAML or
``Wilkins.run(trace=...)``); when off, no recorder exists and every hook
site is a single ``None`` test.  See DESIGN.md "Observability & tracing".
"""

from .recorder import (CATEGORIES, SpanRecorder, TraceConfig, created_count,
                       flow_id, span_categories)
from .export import export_trace, load_trace, merge_timeline, to_chrome
from .critical import attribute, critical_path, format_report, per_edge

__all__ = [
    "CATEGORIES", "SpanRecorder", "TraceConfig", "created_count", "flow_id",
    "span_categories", "export_trace", "load_trace", "merge_timeline",
    "to_chrome", "attribute", "critical_path", "format_report", "per_edge",
]
