"""repro_torch.obs — structured tracing + metrics for the exchange stack,
transcribed from the reference's ``repro.obs`` (the trace and metrics
files are its formats, so either package reads the other's).

Three small modules, one discipline (observe the same decomposition the
model prices):

* :mod:`repro_torch.obs.trace` — hierarchical spans (``program_iteration`` →
  ``exchange`` → ``plan``/``pack``/``wire``/``unpack`` → ``stencil``)
  with decision signatures and predicted-seconds attributes,
  recorded on eager paths only (never while a CUDA graph is captured);
* :mod:`repro_torch.obs.metrics` — process-local counters/gauges
  (:meth:`Communicator.stats` publishes; ``save()`` persists);
* :mod:`repro_torch.obs.export` — Chrome-trace JSON (Perfetto /
  ``chrome://tracing``), text flamechart summaries joining observed
  phase times against model predictions, and the CI trace validator.

``python -m repro_torch.obs {summary,validate} TRACE.json`` is the CLI.
"""

from repro_torch.obs.export import (
    aggregate_events,
    aggregate_spans,
    load_chrome_trace,
    save_chrome_trace,
    summary,
    to_chrome_trace,
    validate,
)
from repro_torch.obs.metrics import (
    METRICS_FILENAME,
    METRICS_FORMAT,
    MetricsRegistry,
    default_metrics,
    publish_comm_stats,
)
from repro_torch.obs.trace import (
    DEFAULT_MAX_SPANS,
    PHASES,
    TRACE_FORMAT,
    Span,
    Tracer,
    attribute_program_iteration,
)

__all__ = [
    "TRACE_FORMAT",
    "PHASES",
    "DEFAULT_MAX_SPANS",
    "Span",
    "Tracer",
    "attribute_program_iteration",
    "METRICS_FORMAT",
    "METRICS_FILENAME",
    "MetricsRegistry",
    "default_metrics",
    "publish_comm_stats",
    "to_chrome_trace",
    "save_chrome_trace",
    "load_chrome_trace",
    "aggregate_spans",
    "aggregate_events",
    "summary",
    "validate",
]
