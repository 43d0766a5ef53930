"""Fleet layer: the engine's runtime feedback loop, transcribed from the
reference's ``repro.fleet`` (telemetry, drift reports and bundles are
its file formats, so either package reads the other's).

Selections are *predictive* — canonical types are priced on
once-measured tables and the winning strategies are pinned.  This
package closes the loop:

* :mod:`repro_torch.fleet.telemetry` — per-exchange observed wall time,
  aggregated per decision key (observed vs predicted, always one
  division away);
* :mod:`repro_torch.fleet.drift` — flag stale decisions, attribute the
  drift to a model term, re-measure *only* that term's table;
* :mod:`repro_torch.fleet.bundle` — generation-numbered decision
  envelopes with deterministic merge, diff, promote and rollback.

``python -m repro_torch.fleet {report,stats,diff,merge,promote}`` is the
operator surface.
"""

from repro_torch.fleet.bundle import (
    BUNDLE_FORMAT,
    CONFLICT_POLICIES,
    DecisionBundle,
    diff_bundles,
    load_bundle,
    merge_bundles,
    promote,
    rollback,
)
from repro_torch.fleet.drift import (
    DEFAULT_COMPRESS_MARGIN,
    DEFAULT_MIN_SAMPLES,
    DEFAULT_OVERLAP_MARGIN,
    DEFAULT_THRESHOLD,
    TERMS,
    DriftDetector,
    DriftFinding,
    DriftReport,
    demote_stale_compress,
    demote_stale_modes,
    remeasure_term,
)
from repro_torch.fleet.telemetry import (
    DEFAULT_WINDOW,
    TELEMETRY_FILENAME,
    TELEMETRY_FORMAT,
    ExchangeTelemetry,
    RingAggregate,
    predict_class_completions,
    predict_program_iteration,
    predict_program_phases,
)

__all__ = [
    "BUNDLE_FORMAT",
    "CONFLICT_POLICIES",
    "DEFAULT_MIN_SAMPLES",
    "DEFAULT_COMPRESS_MARGIN",
    "DEFAULT_OVERLAP_MARGIN",
    "DEFAULT_THRESHOLD",
    "DEFAULT_WINDOW",
    "TELEMETRY_FILENAME",
    "TELEMETRY_FORMAT",
    "TERMS",
    "DecisionBundle",
    "DriftDetector",
    "DriftFinding",
    "DriftReport",
    "ExchangeTelemetry",
    "RingAggregate",
    "demote_stale_compress",
    "demote_stale_modes",
    "diff_bundles",
    "load_bundle",
    "merge_bundles",
    "predict_class_completions",
    "predict_program_iteration",
    "predict_program_phases",
    "promote",
    "remeasure_term",
    "rollback",
]
