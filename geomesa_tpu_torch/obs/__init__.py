"""Observability: Dapper-style request tracing (spans, wire
propagation, bounded ring + JSONL export — trace.py) plus the runtime
health plane: shape-class probes, dispatches, device memory and
transfer bytes (runtime.py), the SLO burn-rate engine with its
admission-tightening reaction loop (slo.py), and the sampling
profiler + stall watchdog (prof.py). The
metrics histograms live in ``geomesa_tpu_torch.metrics``; the audit
plane in ``geomesa_tpu_torch.audit``."""

from .prof import (PROF_HZ, ContinuousProfiler, StallWatchdog, profiler,
                   watchdog)
from .runtime import RUNTIME_ENABLED, RuntimeCollector, runtime
from .slo import (SLO_ENABLED, SLO_REACT, SloEngine, slo_engine)
from .trace import (TRACE_HEADER, TRACE_MAX_SPANS, TRACE_PATH,
                    TRACE_SAMPLE, TRACE_SLOW_MS, Span, Tracer, annotate,
                    current_trace_id, get_flag, set_flag, tracer)

__all__ = ["TRACE_HEADER", "TRACE_SAMPLE", "TRACE_SLOW_MS",
           "TRACE_MAX_SPANS", "TRACE_PATH", "Span", "Tracer", "tracer",
           "annotate", "set_flag", "get_flag", "current_trace_id",
           "RuntimeCollector", "runtime", "RUNTIME_ENABLED",
           "SloEngine", "slo_engine", "SLO_ENABLED", "SLO_REACT",
           "ContinuousProfiler", "StallWatchdog", "profiler",
           "watchdog", "PROF_HZ"]
