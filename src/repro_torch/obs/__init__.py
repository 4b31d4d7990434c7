"""Observability (counterpart of ``repro.obs``): the typed metric records
and the one round-summary constructor (``records``), the pipeline that
fans records out to sinks (``metrics``) and the Chrome/Perfetto trace of
the simulated schedule (``trace``).  The plan audit and the debug
switches (``audit``, ``jitwatch``, ``debug``) are not ported yet."""
from repro_torch.obs.metrics import (CsvSink, JsonlSink, MemorySink,
                                     MetricsPipeline, make_sink)
from repro_torch.obs.records import (SCHEMA_VERSION, MetricRecord,
                                     annotate_schedule, counter,
                                     fedbuff_summary, gauge,
                                     records_from_round, round_summary,
                                     series)
from repro_torch.obs.trace import (TraceBuilder, span_seconds_by_track,
                                   validate_trace)

__all__ = [
    "CsvSink", "JsonlSink", "MemorySink", "MetricRecord", "MetricsPipeline",
    "SCHEMA_VERSION", "TraceBuilder", "annotate_schedule", "counter",
    "fedbuff_summary", "gauge", "make_sink", "records_from_round",
    "round_summary", "series", "span_seconds_by_track", "validate_trace",
]
