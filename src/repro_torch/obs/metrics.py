"""Process-local metrics registry: counters and gauges.

The span tree (:mod:`repro_torch.obs.trace`) answers "where did the time
go"; this module answers "how much traffic went through" with a handful
of named scalars a host can snapshot at any point:

counters (cumulative)
    wire ops issued (``comm.exchanges``), exact payload bytes moved
    (``comm.wire_payload_bytes``), per-delta-class issue tallies
    (``comm.wire_class.<plan>/c<g>.ops`` / ``.bytes``), decision-cache
    hits/misses, drift findings.
gauges (instantaneous)
    telemetry ring occupancy (how full the observation windows are), the
    per-delta-class drain position from the last drain
    (``comm.wire_class.<plan>/c<g>.drain_order``), the compressed wire's
    achieved ratio (``comm.compress.ratio``).

:meth:`repro_torch.comm.api.Communicator.stats` publishes its counters
here on every call (:func:`publish_comm_stats`), and
``production_communicator``'s ``save()`` persists the snapshot to
``metrics.json`` next to the decisions file, so
``python -m repro_torch.fleet stats`` reads a host's counters without
attaching to the process.  The file is the reference's format.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Union

__all__ = [
    "METRICS_FORMAT",
    "METRICS_FILENAME",
    "MetricsRegistry",
    "default_metrics",
    "publish_comm_stats",
]

#: bump when the persisted snapshot schema changes incompatibly
METRICS_FORMAT = 1

#: the metrics snapshot lives next to ``decisions.json`` in the store
METRICS_FILENAME = "metrics.json"


class MetricsRegistry:
    """Named counters + gauges, process-local, no locks (the hot-path
    cost is one dict write)."""

    def __init__(self):
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}

    # -- writes ----------------------------------------------------------
    def inc(self, name: str, delta: float = 1.0) -> None:
        self._counters[name] = self._counters.get(name, 0.0) + delta

    def set_counter(self, name: str, value: float) -> None:
        """Install a cumulative value owned elsewhere (e.g. the
        Communicator's own ``wire_ops`` tally) — last write wins."""
        self._counters[name] = float(value)

    def set_gauge(self, name: str, value: float) -> None:
        self._gauges[name] = float(value)

    # -- reads -----------------------------------------------------------
    def counter(self, name: str) -> float:
        return self._counters.get(name, 0.0)

    def gauge(self, name: str) -> float:
        return self._gauges.get(name, 0.0)

    def __len__(self) -> int:
        return len(self._counters) + len(self._gauges)

    def snapshot(self) -> dict:
        """Point-in-time copy, key-sorted (deterministic)."""
        return {
            "counters": dict(sorted(self._counters.items())),
            "gauges": dict(sorted(self._gauges.items())),
        }

    def clear(self) -> None:
        self._counters.clear()
        self._gauges.clear()

    # -- report ----------------------------------------------------------
    def report(self) -> str:
        lines = [f"{'metric':32s} {'kind':7s} {'value':>16s}"]
        for name, v in sorted(self._counters.items()):
            shown = f"{int(v)}" if float(v).is_integer() else f"{v:.6g}"
            lines.append(f"{name:32s} {'counter':7s} {shown:>16s}")
        for name, v in sorted(self._gauges.items()):
            lines.append(f"{name:32s} {'gauge':7s} {v:>16.4f}")
        return "\n".join(lines)

    # -- persistence -----------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({"format": METRICS_FORMAT, **self.snapshot()}, indent=2)

    @staticmethod
    def from_json(s: str) -> "MetricsRegistry":
        d = json.loads(s)
        if d.get("format") != METRICS_FORMAT:
            raise ValueError(
                f"metrics snapshot format {d.get('format')!r} != {METRICS_FORMAT}"
            )
        m = MetricsRegistry()
        for k, v in d.get("counters", {}).items():
            m.set_counter(k, v)
        for k, v in d.get("gauges", {}).items():
            m.set_gauge(k, v)
        return m

    def save(self, path: Union[str, Path]) -> Path:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.with_suffix(".tmp")
        tmp.write_text(self.to_json())
        tmp.replace(p)
        return p

    @staticmethod
    def load(path: Union[str, Path]) -> "MetricsRegistry":
        """Load a persisted snapshot; an absent file yields an empty
        registry."""
        p = Path(path)
        if not p.exists():
            return MetricsRegistry()
        return MetricsRegistry.from_json(p.read_text())


_DEFAULT = MetricsRegistry()


def default_metrics() -> MetricsRegistry:
    """The process-global registry everything publishes into."""
    return _DEFAULT


def publish_comm_stats(
    stats: Dict[str, int],
    telemetry=None,
    registry: Optional[MetricsRegistry] = None,
) -> MetricsRegistry:
    """Mirror a :meth:`Communicator.stats` dict (plus the attached
    telemetry's ring occupancy) into the registry.  Counters are the
    communicator's own cumulative tallies, installed as-is."""
    m = registry if registry is not None else _DEFAULT
    m.set_counter("comm.exchanges", stats.get("wire_ops", 0))
    m.set_counter("comm.wire_payload_bytes", stats.get("wire_payload_bytes", 0))
    m.set_counter("comm.wire_classes", stats.get("wire_classes", 0))
    for key, v in (stats.get("wire_class_ops") or {}).items():
        m.set_counter(f"comm.wire_class.{key}.ops", v)
    for key, v in (stats.get("wire_class_bytes") or {}).items():
        m.set_counter(f"comm.wire_class.{key}.bytes", v)
    for key, v in (stats.get("wire_class_drains") or {}).items():
        m.set_gauge(f"comm.wire_class.{key}.drain_order", v)
    m.set_counter("comm.compress.exchanges", stats.get("compress_exchanges", 0))
    m.set_counter("comm.compress.capacity_bytes", stats.get("compress_capacity_bytes", 0))
    m.set_counter("comm.compress.stream_bytes", stats.get("compress_stream_bytes", 0))
    m.set_gauge("comm.compress.ratio", stats.get("compress_ratio", 1.0))
    m.set_counter("comm.committed_types", stats.get("committed_types", 0))
    m.set_counter("comm.commit_hits", stats.get("commit_hits", 0))
    hits = stats.get("model_hits", 0)
    m.set_counter("decisions.cache_hits", hits)
    m.set_counter("decisions.cache_misses", max(stats.get("model_lookups", 0) - hits, 0))
    if telemetry is not None:
        rows = telemetry.aggregates()
        cap = sum(a.capacity for a in rows)
        m.set_counter("telemetry.observations", sum(a.total_count for a in rows))
        m.set_gauge("telemetry.ring_occupancy",
                    (sum(a.count for a in rows) / cap) if cap else 0.0)
    return m
