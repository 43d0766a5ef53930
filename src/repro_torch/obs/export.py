"""Span export: Chrome-trace JSON, text flamecharts, trace validation.

Chrome-trace JSON (the ``traceEvents`` "X" complete-event form) loads
directly in Perfetto / ``chrome://tracing``.  Every event keeps its
span/parent ids and attributes in ``args``, so a saved trace round-trips
losslessly: :func:`aggregate_events` rebuilds the per-decision phase
sums :mod:`repro_torch.fleet.drift` consumes, and :func:`summary` renders the
flamechart with *observed* wall time beside the *predicted* model terms
each span recorded at trace time (``args.pred``) — model error visible
per phase, per exchange, without the model in hand.

:func:`validate` is the CI invariant check on an exported trace:

* well-formed Chrome-trace JSON (``traceEvents`` list of timed events);
* every ``exchange`` span carries a decision signature (``fingerprint``
  + ``strategy``);
* every ``wire_class`` span (per-delta-class completion, region-split
  overlap) identifies its class: a ``class`` index plus the wire-plan
  key (``fingerprint`` on eager drains, ``key`` on attributed ones);
* communication avoidance holds: a ``program_iteration`` span with
  fusion depth ``s`` contains at most ONE exchange and at least
  ``s`` stencil applications — exchanges per application <= 1/s.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.obs.trace import PHASES, TRACE_FORMAT, Span, Tracer

__all__ = [
    "to_chrome_trace",
    "save_chrome_trace",
    "load_chrome_trace",
    "aggregate_spans",
    "aggregate_events",
    "summary",
    "validate",
]

#: Perfetto category per span name (anything else renders as "misc")
_CATEGORIES = {
    "program_iteration": "program",
    "exchange": "comm",
    "plan": "comm",
    "pack": "comm",
    "wire": "comm",
    "wire_class": "comm",
    "unpack": "comm",
    "stencil": "compute",
}


def _jsonable(v):
    """Span attributes are free-form; coerce the numpy scalars, torch
    scalars and 0-d tensors that leak in from shape math (anything with
    an ``item()``) so json.dumps never chokes."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    item = getattr(v, "item", None)
    if callable(item):
        try:
            return item()
        except Exception:  # pragma: no cover - exotic attr types
            pass
    return str(v)


def to_chrome_trace(tracer: Tracer) -> dict:
    """The tracer's spans as a Chrome-trace JSON object (timestamps in
    microseconds relative to the earliest span)."""
    spans = tracer.spans
    epoch = min((s.start for s in spans), default=0.0)
    events = []
    for s in spans:
        args = {k: _jsonable(v) for k, v in s.attrs.items()}
        args["span_id"] = s.span_id
        if s.parent_id is not None:
            args["parent_id"] = s.parent_id
        events.append({
            "name": s.name,
            "cat": _CATEGORIES.get(s.name, "misc"),
            "ph": "X",
            "ts": (s.start - epoch) * 1e6,
            "dur": s.duration * 1e6,
            "pid": 0,
            "tid": 0,
            "args": args,
        })
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "format": TRACE_FORMAT,
            "generator": "repro_torch.obs",
            "dropped_spans": tracer.dropped,
        },
    }


def save_chrome_trace(tracer: Tracer, path: Union[str, Path]) -> Path:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(to_chrome_trace(tracer), indent=1))
    return p


def load_chrome_trace(path: Union[str, Path]) -> dict:
    return json.loads(Path(path).read_text())


# ---------------------------------------------------------------------------
# aggregation (the drift-attribution feed)
# ---------------------------------------------------------------------------

def _events_as_spans(events: Sequence[dict]) -> List[Span]:
    """Rebuild light :class:`Span` records from exported events (events
    without a ``span_id`` — foreign traces — are skipped)."""
    out = []
    for ev in events:
        args = ev.get("args") or {}
        sid = args.get("span_id")
        if sid is None or ev.get("ph") != "X":
            continue
        attrs = {k: v for k, v in args.items()
                 if k not in ("span_id", "parent_id")}
        out.append(Span(
            name=ev.get("name", ""),
            start=float(ev.get("ts", 0.0)) * 1e-6,
            duration=float(ev.get("dur", 0.0)) * 1e-6,
            span_id=int(sid),
            parent_id=args.get("parent_id"),
            attrs=attrs,
        ))
    return out


def aggregate_spans(
    spans: Sequence[Span],
) -> Dict[str, Dict[str, Dict[str, float]]]:
    """Per-decision-fingerprint phase sums:
    ``{fingerprint: {phase: {count, observed, predicted, attributed}}}``.

    Each pack/wire/unpack/stencil span is credited to the nearest
    enclosing span carrying a ``fingerprint`` attribute (the decision
    key), summing observed wall seconds and the predicted seconds the
    span recorded (``pred``).  ``attributed`` counts the spans whose
    timing was model-proportioned rather than directly measured, so a
    consumer can tell a real per-phase observation from a scaled one.
    """
    by_id = {s.span_id: s for s in spans}
    out: Dict[str, Dict[str, Dict[str, float]]] = {}
    for s in spans:
        if s.name not in PHASES:
            continue
        p = by_id.get(s.parent_id) if s.parent_id is not None else None
        while p is not None and "fingerprint" not in p.attrs:
            p = (by_id.get(p.parent_id)
                 if p.parent_id is not None else None)
        if p is None:
            continue
        fp = str(p.attrs["fingerprint"])
        rec = out.setdefault(fp, {}).setdefault(
            s.name,
            {"count": 0, "observed": 0.0, "predicted": 0.0,
             "attributed": 0},
        )
        rec["count"] += 1
        rec["observed"] += s.duration
        rec["predicted"] += float(s.attrs.get("pred", 0.0) or 0.0)
        if s.attrs.get("attributed"):
            rec["attributed"] += 1
    return out


def aggregate_events(
    trace: dict,
) -> Dict[str, Dict[str, Dict[str, float]]]:
    """:func:`aggregate_spans` over a loaded Chrome-trace dict — the
    file-based path into ``DriftDetector.audit(trace=...)``."""
    return aggregate_spans(_events_as_spans(trace.get("traceEvents", ())))


# ---------------------------------------------------------------------------
# text flamechart (predicted vs observed)
# ---------------------------------------------------------------------------

def _children(spans: Sequence[Span]) -> Dict[Optional[int], List[Span]]:
    kids: Dict[Optional[int], List[Span]] = {}
    for s in spans:
        kids.setdefault(s.parent_id, []).append(s)
    for v in kids.values():
        v.sort(key=lambda s: s.start)
    return kids


def _render_group(lines: List[str], group: List[Span],
                  kids: Dict[Optional[int], List[Span]],
                  indent: int) -> None:
    """One flamechart row per (name, signature) sibling group: count,
    observed mean, predicted mean, obs/pred ratio."""
    n = len(group)
    obs = sum(s.duration for s in group)
    pred = sum(float(s.attrs.get("pred", 0.0) or 0.0) for s in group)
    head = group[0]
    sig = ""
    if "fingerprint" in head.attrs:
        sig = (f" fp={head.attrs['fingerprint']}"
               f" {head.attrs.get('strategy', '')}")
        if "schedule" in head.attrs:
            sig += f" {head.attrs['schedule']}/{head.attrs.get('wire_bytes', '?')}B"
    attributed = any(s.attrs.get("attributed") for s in group)
    ratio = f"{obs / pred:8.3f}" if pred > 0 else f"{'-':>8s}"
    lines.append(
        f"{'  ' * indent}{head.name:<{max(24 - 2 * indent, 8)}s}"
        f" n={n:<5d} obs={obs / n * 1e6:10.1f}us"
        f" pred={pred / n * 1e6:10.1f}us obs/pred={ratio}"
        f"{' [attributed]' if attributed else ''}{sig}"
    )
    # recurse: pool the whole sibling group's children, regroup by name
    sub: Dict[Tuple[str, str], List[Span]] = {}
    order: List[Tuple[str, str]] = []
    for s in group:
        for c in kids.get(s.span_id, ()):
            key = (c.name, str(c.attrs.get("fingerprint", "")))
            if key not in sub:
                sub[key] = []
                order.append(key)
            sub[key].append(c)
    for key in order:
        _render_group(lines, sub[key], kids, indent + 1)


def summary(trace: dict) -> str:
    """Text flamechart of an exported trace: the span hierarchy with
    observed phase means joined against the PerfModel predictions each
    span carried (``pred``) — the ``python -m repro_torch.obs summary``
    output."""
    spans = _events_as_spans(trace.get("traceEvents", ()))
    if not spans:
        return "trace summary: no spans"
    kids = _children(spans)
    total = sum(s.duration for s in kids.get(None, ()))
    dropped = (trace.get("otherData") or {}).get("dropped_spans", 0)
    lines = [
        f"trace summary: {len(spans)} spans, "
        f"{total * 1e6:.1f}us at the root"
        + (f", {dropped} dropped" if dropped else "")
    ]
    roots: Dict[Tuple[str, str], List[Span]] = {}
    order: List[Tuple[str, str]] = []
    for s in kids.get(None, ()):
        key = (s.name, str(s.attrs.get("fingerprint", "")))
        if key not in roots:
            roots[key] = []
            order.append(key)
        roots[key].append(s)
    for key in order:
        _render_group(lines, roots[key], kids, 0)
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# validation (the CI invariant check)
# ---------------------------------------------------------------------------

def validate(trace: dict) -> List[str]:
    """Invariant-check an exported trace; returns the violations (empty
    = valid).  See module docstring for the checked invariants."""
    errors: List[str] = []
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event {i}: not an object")
            continue
        if ev.get("ph") != "X":
            errors.append(f"event {i}: ph={ev.get('ph')!r} != 'X'")
        if not isinstance(ev.get("name"), str):
            errors.append(f"event {i}: missing name")
        for k in ("ts", "dur"):
            if not isinstance(ev.get(k), (int, float)):
                errors.append(f"event {i}: {k} not numeric")
    if errors:
        return errors

    spans = _events_as_spans(events)
    kids = _children(spans)
    for s in spans:
        if s.name == "exchange":
            for k in ("fingerprint", "strategy"):
                if not s.attrs.get(k):
                    errors.append(
                        f"exchange span {s.span_id}: no decision "
                        f"signature ({k} missing)"
                    )
        if s.name == "wire_class":
            if s.attrs.get("class") is None:
                errors.append(
                    f"wire_class span {s.span_id}: no class index"
                )
            if not (s.attrs.get("fingerprint") or s.attrs.get("key")):
                errors.append(
                    f"wire_class span {s.span_id}: no wire-plan key "
                    "(fingerprint/key missing)"
                )
        if s.name == "program_iteration":
            steps = int(s.attrs.get("steps", 1) or 1)
            ex = [c for c in kids.get(s.span_id, ())
                  if c.name == "exchange"]
            # a fused pair's span holds two applications
            st = sum(int(c.attrs.get("applications", 1)) for c in kids.get(s.span_id, ())
                     if c.name == "stencil")
            if len(ex) > 1:
                errors.append(
                    f"program_iteration span {s.span_id}: {len(ex)} "
                    "exchanges in one iteration (expected <= 1)"
                )
            if ex and st < steps:
                errors.append(
                    f"program_iteration span {s.span_id}: "
                    f"{st} stencil applications < steps={steps} — "
                    f"exchanges per application exceed 1/s"
                )
    return errors
