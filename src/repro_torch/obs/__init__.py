"""Observability (counterpart of ``repro.obs``), layered over the engine
without touching its hot path:

  records   typed metric records and the one round-summary constructor
  metrics   the pipeline that fans records out to sinks
  trace     the Chrome/Perfetto trace of the simulated schedule and of
            the programs' host spans
  jitwatch  program-entry spans: calls, graph captures, host time,
            kernel launches
  audit     reconcile an ExecutionPlan's predictions with an observed run
  debug     the NaN check and the f64 default behind environment switches
"""
from repro_torch.obs import debug, jitwatch
from repro_torch.obs.audit import AuditReport, PlanDriftError, audit_run
from repro_torch.obs.metrics import (CsvSink, JsonlSink, MemorySink,
                                     MetricsPipeline, make_sink)
from repro_torch.obs.records import (SCHEMA_VERSION, MetricRecord,
                                     annotate_schedule, counter,
                                     fedbuff_summary, gauge,
                                     records_from_round, round_summary,
                                     series)
from repro_torch.obs.trace import (TraceBuilder, span_seconds_by_track,
                                   validate_trace)

# applied once a process: a no-op unless REPRO_DEBUG_NANS / REPRO_X64 are
# set
debug.configure_from_env()

__all__ = [
    "AuditReport", "CsvSink", "JsonlSink", "MemorySink", "MetricRecord",
    "MetricsPipeline", "PlanDriftError", "SCHEMA_VERSION", "TraceBuilder",
    "annotate_schedule", "audit_run", "counter", "debug",
    "fedbuff_summary", "gauge", "jitwatch", "make_sink",
    "records_from_round", "round_summary", "series",
    "span_seconds_by_track", "validate_trace",
]
