"""Telemetry hub and span stream for the control plane (copies of
``repro.obs.telemetry`` and ``repro.obs.spans``; the timeline and report
tools are not copied yet)."""
from repro_torch.obs.spans import (
    TRACE_EVENT_KEYS,
    TRACE_SCHEMA,
    SpanEvent,
    chrome_trace,
    read_jsonl,
    to_jsonl,
)
from repro_torch.obs.telemetry import (
    NULL_TELEMETRY,
    Histogram,
    NullTelemetry,
    Telemetry,
)

__all__ = [
    "Telemetry", "NullTelemetry", "NULL_TELEMETRY", "Histogram",
    "SpanEvent", "chrome_trace", "to_jsonl", "read_jsonl",
    "TRACE_SCHEMA", "TRACE_EVENT_KEYS",
]
