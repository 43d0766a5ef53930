"""Drift detection + targeted re-measurement, transcribed from the
reference's ``repro.fleet.drift`` (the report is its format 2, and
format-1 reports still load).

A pinned :class:`~repro_torch.measure.decisions.Decision` carries the terms
the model believed at decision time (``t_pack`` / ``t_link`` /
``t_unpack``).  Two things can invalidate it:

* the **system moved** — a torch or CUDA upgrade, thermal
  throttling: the stored :class:`~repro_torch.comm.perfmodel.SystemParams`
  tables no longer describe the machine.  Detected by comparing the
  stored tables against a *reference* calibration (freshly measured, or
  the CI artifact recorded minutes ago) term by term;
* the **traffic moved** — runtime observations
  (:class:`~repro_torch.fleet.telemetry.ExchangeTelemetry`) diverge from the
  recorded price beyond a threshold over a minimum sample count.

Either way the response is the same and *targeted*: re-measure only the
drifted term's table (:func:`remeasure_term` re-runs just that
``measure.bench`` sweep), not the full calibration — the paper's
"record once" economy survives contact with a fleet.

Term attribution maps the model's cost decomposition onto the sweep
that produced each term:

====================  =======================================  ==========
term                  decision rows it prices                   sweep
====================  =======================================  ==========
``wire``              ``wire/<schedule>`` exchange rows; the    ``measure_wire_table``
                      ``t_link`` of every strategy row; the
                      exchange half of ``program/s=N`` rows
``pack_unpack``       ``t_pack``/``t_unpack`` of strategy rows  ``measure_pack_table`` +
                                                                ``measure_unpack_table``
``stencil``           the redundant-compute half of             ``measure_stencil_table``
                      ``program/s=N`` rows
``copy``              the contiguous-copy proxy terms           ``measure_copy_table``
``compress``          the encode/decode cost of compressed      ``measure_compress_table``
                      strategy rows; the achieved-ratio check
                      of ``wire/varlen`` pins (telemetry ring)
====================  =======================================  ==========

The whole audit is machine-readable: :class:`DriftReport` serializes to
JSON (CI asserts well-formedness and gates on ``drifted_count == 0``),
and ``python -m repro_torch.fleet report`` renders it next to the telemetry
table.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.comm.perfmodel import PerfModel, SystemParams, _Interp1D, _Interp2D
from repro_torch.fleet.telemetry import ExchangeTelemetry

__all__ = [
    "DRIFT_FORMAT",
    "TERMS",
    "DEFAULT_THRESHOLD",
    "DEFAULT_MIN_SAMPLES",
    "DEFAULT_OVERLAP_MARGIN",
    "DEFAULT_COMPRESS_MARGIN",
    "DriftFinding",
    "DriftReport",
    "DriftDetector",
    "remeasure_term",
    "demote_stale_modes",
    "demote_stale_compress",
]

#: bump when the persisted DriftReport schema changes incompatibly.
#: Format 2: finding ``source`` distinguishes ``"trace"`` (direct
#: per-phase span observation), ``"telemetry"`` (whole-exchange runtime
#: ratio) and ``"interpolated"`` (table-interpolation inference, the
#: format-1 ``"params"``); findings gain ``phase_ratios``.  Format-1
#: files still load (``from_json`` normalizes old source labels).
DRIFT_FORMAT = 2

#: older report formats ``from_json`` accepts (normalized on load)
_COMPAT_FORMATS = (1, DRIFT_FORMAT)

#: which model term each trace phase span is evidence for
_PHASE_TERM = {
    "wire": "wire",
    "pack": "pack_unpack",
    "unpack": "pack_unpack",
    "stencil": "stencil",
}

#: the model terms a drift can be attributed to, each owning exactly one
#: calibration sweep (see module docstring table)
TERMS: Tuple[str, ...] = ("wire", "pack_unpack", "stencil", "copy", "compress")

#: flag when stored/reference (or observed/predicted) diverge beyond
#: this factor in either direction — generous because CPU-runner sweeps
#: are noisy; a fleet with stable hardware should tighten it
DEFAULT_THRESHOLD = 5.0

#: runtime findings need at least this many window samples: one slow
#: exchange is an outlier, a windowful is drift
DEFAULT_MIN_SAMPLES = 8

#: an ``overlap/mode=<m>`` pin is stale when the *measured* iteration
#: time of the chosen mode exceeds the best measured alternative by
#: this factor — much tighter than :data:`DEFAULT_THRESHOLD` because
#: the comparison is same-machine same-moment (both modes timed in one
#: smoother run), so table noise does not apply
DEFAULT_OVERLAP_MARGIN = 1.25

#: a ``wire/varlen`` pin is stale when the *achieved* compression ratio
#: (the per-exchange stream/capacity observations in the telemetry ring
#: keyed ``<fingerprint>/ratio``) decays past the probed ratio recorded
#: in the pin's signature by this factor — the schedule is then moving
#: more bytes than the price it was chosen on.  Tight like the overlap
#: margin: both sides are same-payload same-machine observations, no
#: table noise involved
DEFAULT_COMPRESS_MARGIN = 1.25

#: the probed stream ratio a compressed pin's signature records
#: (``... ratio=0.0514 ...``)
_RATIO_RE = re.compile(r"\bratio=([0-9.eE+-]+)")


def _pinned_ratio(signature: str) -> Optional[float]:
    m = _RATIO_RE.search(signature or "")
    if m is None:
        return None
    try:
        return float(m.group(1))
    except ValueError:
        return None


@dataclass(frozen=True)
class DriftFinding:
    """One decision row's drift verdict.

    ``source`` says where the term attribution came from, strongest
    evidence first: ``"trace"`` — direct per-phase span observations
    (``DriftDetector.audit(trace=...)``); ``"telemetry"`` — the
    whole-exchange runtime ratio flagged it; ``"interpolated"`` — the
    term was *inferred* by interpolating stored vs reference calibration
    tables (no runtime observation involved).  Consumers gating on
    ``--assert-no-drift`` can weigh a ``"trace"`` finding above an
    inferred one.
    """

    fingerprint: str
    strategy: str
    term: str            # attributed term ("" when nothing diverges)
    ratio: float         # observed/predicted (trace) or stored/reference
    drifted: bool
    source: str          # "trace" | "telemetry" | "interpolated"
    recorded_total: float = 0.0   # the Decision's recorded price (sec)
    repriced_total: float = 0.0   # same decision priced on the reference
    observed_mean: float = 0.0    # runtime mean (telemetry joins only)
    observed_ratio: float = 0.0   # observed/predicted (0 = no telemetry)
    samples: int = 0
    signature: str = ""
    #: per-term observed/predicted ratios from trace aggregates (empty
    #: without a trace join) — the direct attribution evidence
    phase_ratios: Dict[str, float] = field(default_factory=dict)


@dataclass
class DriftReport:
    """Machine-readable audit result: per-term table ratios + per-row
    findings.  ``drifted_count == 0`` is the CI gate."""

    system: str
    threshold: float
    min_samples: int
    term_ratios: Dict[str, float] = field(default_factory=dict)
    findings: Tuple[DriftFinding, ...] = ()

    @property
    def drifted(self) -> Tuple[DriftFinding, ...]:
        return tuple(f for f in self.findings if f.drifted)

    @property
    def drifted_count(self) -> int:
        return len(self.drifted)

    @property
    def drifted_terms(self) -> Tuple[str, ...]:
        """The distinct attributed terms, sorted — what
        :func:`remeasure_term` should be pointed at."""
        return tuple(sorted({f.term for f in self.drifted if f.term}))

    def to_json(self) -> str:
        return json.dumps(
            {
                "format": DRIFT_FORMAT,
                "system": self.system,
                "threshold": self.threshold,
                "min_samples": self.min_samples,
                "term_ratios": dict(sorted(self.term_ratios.items())),
                "findings": [dataclasses.asdict(f) for f in self.findings],
            },
            indent=2,
        )

    @staticmethod
    def from_json(s: str) -> "DriftReport":
        d = json.loads(s)
        if d.get("format") not in _COMPAT_FORMATS:
            raise ValueError(
                f"drift report format {d.get('format')!r} not in "
                f"{_COMPAT_FORMATS}"
            )
        findings = []
        for row in d.get("findings", ()):
            row = dict(row)
            # format 1 called table-interpolation findings "params"
            if row.get("source") == "params":
                row["source"] = "interpolated"
            findings.append(DriftFinding(**row))
        return DriftReport(
            system=d.get("system", ""),
            threshold=float(d["threshold"]),
            min_samples=int(d["min_samples"]),
            term_ratios=dict(d.get("term_ratios", {})),
            findings=tuple(findings),
        )

    def save(self, path: Union[str, Path]) -> Path:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(self.to_json())
        return p

    def summary(self) -> str:
        lines = [
            f"drift audit: {len(self.findings)} decisions, "
            f"{self.drifted_count} drifted "
            f"(threshold x{self.threshold:g}, min_samples "
            f"{self.min_samples})"
        ]
        for t in TERMS:
            if t in self.term_ratios:
                lines.append(
                    f"  term {t:12s} stored/reference = "
                    f"{self.term_ratios[t]:.3f}"
                )
        for f in self.findings:
            mark = "DRIFT" if f.drifted else "ok"
            obs = (
                f" observed/pred={f.observed_ratio:.2f} (n={f.samples})"
                if f.samples else ""
            )
            lines.append(
                f"  [{mark:5s}] {f.fingerprint:16s} {f.strategy:14s} "
                f"term={f.term or '-':11s} ratio={f.ratio:.3f} "
                f"source={f.source}{obs}"
            )
        return "\n".join(lines)


def _geomean_ratio(pairs: Sequence[Tuple[float, float]]) -> Optional[float]:
    """Geometric mean of a/b over positive pairs (None when empty) —
    robust to the odd noisy grid point in a way an arithmetic mean of
    ratios is not."""
    logs = [
        math.log(a / b) for a, b in pairs if a > 0.0 and b > 0.0
    ]
    if not logs:
        return None
    return math.exp(sum(logs) / len(logs))


def _table1d_ratio(stored, reference) -> Optional[float]:
    """stored/reference ratio of two (log2_x, sec) tables, compared by
    interpolating the stored table at the reference's grid points."""
    if not stored or not reference:
        return None
    interp = _Interp1D(tuple(tuple(r) for r in stored))
    return _geomean_ratio([(interp(x), sec) for x, sec in reference])


def _table2d_ratio(stored, reference) -> Optional[float]:
    """Same, for (log2_a, log2_b, sec) tables."""
    if not stored or not reference:
        return None
    interp = _Interp2D(tuple(tuple(r) for r in stored))
    return _geomean_ratio([(interp(x, y), sec) for x, y, sec in reference])


def _strategy_tables_ratio(stored, reference) -> Optional[float]:
    """stored/reference over the per-strategy 2D tables they share."""
    if not stored or not reference:
        return None
    ratios = []
    for name in sorted(set(stored) & set(reference)):
        r = _table2d_ratio(stored[name], reference[name])
        if r is not None:
            ratios.append((r, 1.0))
    return _geomean_ratio(ratios)


def _compress_tables_ratio(stored, reference) -> Optional[float]:
    """stored/reference over the per-compressor sweep tables
    (``(log2_total, compress_sec, decompress_sec, ratio_sample)`` rows):
    both timing columns compared as 1D tables, the informational ratio
    column ignored."""
    if not stored or not reference:
        return None
    ratios = []
    for name in sorted(set(stored) & set(reference)):
        for col in (1, 2):
            r = _table1d_ratio(
                [(row[0], row[col]) for row in stored[name]],
                [(row[0], row[col]) for row in reference[name]],
            )
            if r is not None:
                ratios.append((r, 1.0))
    return _geomean_ratio(ratios)


def _trace_term_ratios(
    rec: Dict[str, dict],
) -> Tuple[Dict[str, float], int]:
    """Observed/predicted ratio per model term from one decision key's
    trace phase aggregates (``{phase: {count, observed, predicted}}``,
    see :func:`repro_torch.obs.export.aggregate_spans`).  The pack and unpack
    phases pool into the one ``pack_unpack`` term (they share a
    calibration sweep).  Returns ``(ratios, samples)`` where samples is
    the per-iteration observation count behind the ratios."""
    by_term: Dict[str, List[float]] = {}
    counts: List[int] = []
    for phase, r in rec.items():
        term = _PHASE_TERM.get(phase)
        if term is None:
            continue
        agg = by_term.setdefault(term, [0.0, 0.0])
        agg[0] += float(r.get("observed", 0.0))
        agg[1] += float(r.get("predicted", 0.0))
        counts.append(int(r.get("count", 0)))
    ratios = {
        t: o / p for t, (o, p) in by_term.items() if o > 0.0 and p > 0.0
    }
    return ratios, (max(counts) if counts else 0)


def _terms_of(strategy: str) -> Tuple[str, ...]:
    """Which model terms a decision row's price is built from, in
    attribution priority order."""
    if strategy.startswith("wire/"):
        return ("wire",)
    if strategy.startswith("program/s="):
        # t_link slot holds the exchange, t_pack slot the redundant
        # stencil compute (see build_halo_program's record call)
        return ("wire", "stencil", "copy")
    if strategy.startswith("overlap/mode="):
        # an overlap-mode row prices stencil compute against wire time
        # (the overlap trade); neither table alone re-measures it — the
        # authoritative check is the smoother's per-mode timings
        return ("stencil", "wire")
    if strategy in ("rlewire", "int8wire"):
        # a compressed-wire selection prices the encode/decode sweep on
        # top of the base pack/unpack terms
        return ("pack_unpack", "compress", "wire")
    return ("pack_unpack", "wire")


class DriftDetector:
    """Compare what the engine believes against a reference (and the
    runtime), flag divergent decisions, attribute each to a term."""

    def __init__(
        self,
        threshold: float = DEFAULT_THRESHOLD,
        min_samples: int = DEFAULT_MIN_SAMPLES,
    ):
        if threshold <= 1.0:
            raise ValueError(f"threshold must be > 1, got {threshold}")
        self.threshold = float(threshold)
        self.min_samples = int(min_samples)

    # -- table-level comparison ------------------------------------------
    def term_ratios(
        self, params: SystemParams, reference: SystemParams
    ) -> Dict[str, float]:
        """stored/reference price ratio per term, from the term's own
        calibration table (absent tables are skipped, not guessed)."""
        out: Dict[str, float] = {}
        r = _table1d_ratio(params.wire_table, reference.wire_table)
        if r is not None:
            out["wire"] = r
        pack = _strategy_tables_ratio(params.pack_table, reference.pack_table)
        unpack = _strategy_tables_ratio(
            params.unpack_table, reference.unpack_table
        )
        pu = _geomean_ratio(
            [(v, 1.0) for v in (pack, unpack) if v is not None]
        )
        if pu is not None:
            out["pack_unpack"] = pu
        r = _table2d_ratio(params.stencil_table, reference.stencil_table)
        if r is not None:
            out["stencil"] = r
        r = _table1d_ratio(params.copy_table, reference.copy_table)
        if r is not None:
            out["copy"] = r
        r = _compress_tables_ratio(
            params.compress_table, reference.compress_table
        )
        if r is not None:
            out["compress"] = r
        return out

    def _out_of_band(self, ratio: float) -> bool:
        return ratio > self.threshold or ratio < 1.0 / self.threshold

    # -- the audit -------------------------------------------------------
    def audit(
        self,
        decisions,
        params: SystemParams,
        reference: Optional[SystemParams] = None,
        telemetry: Optional[ExchangeTelemetry] = None,
        system: str = "",
        trace: Optional[Dict[str, Dict[str, dict]]] = None,
        overlap_timings: Optional[Dict[str, Dict[str, float]]] = None,
        overlap_margin: float = DEFAULT_OVERLAP_MARGIN,
        compress_margin: float = DEFAULT_COMPRESS_MARGIN,
    ) -> DriftReport:
        """One finding per decision row.

        With ``trace`` (per-decision phase aggregates from
        :meth:`repro_torch.obs.Tracer.phase_aggregates` or
        :func:`repro_torch.obs.export.aggregate_events`): a row whose
        fingerprint has trace coverage gets **direct** term attribution
        — each phase's observed/predicted ratio maps onto the term that
        phase is evidence for (pack+unpack pool into ``pack_unpack``),
        the worst out-of-band term wins, and the finding's ``source`` is
        ``"trace"``.  Rows without trace coverage fall back to the
        interpolated path below.

        With ``reference``: each row's terms are checked against the
        reference tables; a row drifts when a term it prices is out of
        band, attributed to the *worst* such term (``source``
        ``"interpolated"`` — the attribution is inferred, not
        observed).  The ``wire`` term is additionally re-priced
        point-wise at the row's exact ``wire_bytes`` (more honest than
        the table-mean for a row living at one message size).  With
        ``telemetry``: rows whose observed/predicted ratio is out of
        band over ``min_samples`` drift too — attributed through the
        reference when one is given, else left unattributed
        (``term=""``; re-measure everything or bring a reference).

        With ``overlap_timings`` (``{fingerprint: {mode: measured
        iteration seconds}}``, the per-mode timings a smoother sweep
        already collects): every ``overlap/mode=<m>`` row is checked
        against what was *measured*, not modeled — the observed ratio
        is the chosen mode's iteration time over the best measured
        alternative mode (``"off"`` excluded: it is the no-overlap
        baseline, not an alternative schedule).  A ratio above
        ``overlap_margin`` flags the pin (``term="overlap"``, source
        ``"telemetry"``); :func:`demote_stale_modes` then deletes it so
        the next smoother pass re-prices.

        ``wire/varlen`` rows carry their probed compression ratio in the
        pin signature (``ratio=<r>``), and every varlen exchange records
        its achieved ratio in the telemetry ring keyed
        ``<fingerprint>/ratio``.  When the ring mean decays past the
        pinned ratio by more than ``compress_margin`` over
        ``min_samples`` observations, the pin drifts (``term="compress"``,
        source ``"telemetry"``): the payload no longer compresses as
        promised, so the schedule is moving more bytes than the price it
        was chosen on.  :func:`demote_stale_compress` deletes flagged
        varlen pins (and probed compressed selections) so the next
        planning pass re-probes.
        """
        ratios = (
            self.term_ratios(params, reference) if reference is not None
            else {}
        )
        model = PerfModel(params)
        ref_model = PerfModel(reference) if reference is not None else None
        findings: List[DriftFinding] = []
        for d in decisions.log:
            terms = _terms_of(d.strategy)
            # per-row term ratios: start from the table-level numbers,
            # refine "wire" at the row's own byte count
            row_ratios: Dict[str, float] = {
                t: ratios[t] for t in terms if t in ratios
            }
            if (
                ref_model is not None
                and "wire" in terms
                and d.wire_bytes > 0
            ):
                hops = max(d.hops, 1)
                stored_link = model.t_link(d.wire_bytes, hops)
                ref_link = ref_model.t_link(d.wire_bytes, hops)
                if stored_link > 0 and ref_link > 0:
                    row_ratios["wire"] = stored_link / ref_link
            source = "interpolated"
            phase_ratios: Dict[str, float] = {}
            trace_samples = 0
            rec = (trace or {}).get(d.fingerprint)
            if rec:
                t_ratios, trace_samples = _trace_term_ratios(rec)
                phase_ratios = {
                    t: r for t, r in t_ratios.items() if t in terms
                }
                if phase_ratios:
                    # direct observation beats inference: the trace's
                    # per-phase ratios replace the interpolated ones
                    row_ratios = phase_ratios
                    source = "trace"
            # re-price the recorded total term by term: each recorded
            # slot divided by its stored/reference ratio (strategy class
            # determines which slot belongs to which term — program rows
            # keep redundant stencil compute in t_pack, see _terms_of)
            per_term = {
                "wire": d.t_link,
                "pack_unpack": d.t_pack + d.t_unpack,
                "stencil": d.t_pack if "stencil" in terms else 0.0,
                "copy": 0.0,
            }
            if "stencil" in terms:
                per_term["pack_unpack"] = 0.0
            repriced = sum(
                per_term.get(t, 0.0) / row_ratios.get(t, 1.0) for t in terms
            )
            worst_term, worst = "", 1.0
            for t, r in row_ratios.items():
                if abs(math.log(r)) > abs(math.log(worst)):
                    worst_term, worst = t, r
            drifted = bool(worst_term) and self._out_of_band(worst)
            if source == "trace":
                # runtime evidence: one slow iteration is an outlier, a
                # windowful is drift — same sample gate as telemetry
                drifted = drifted and trace_samples >= self.min_samples

            obs_mean = obs_ratio = 0.0
            samples = trace_samples if source == "trace" else 0
            agg = telemetry.get(d.fingerprint) if telemetry is not None else None
            if agg is not None:
                obs_mean = agg.mean
                samples = agg.count
                r = agg.ratio
                if r is not None:
                    obs_ratio = r
                    if samples >= self.min_samples and self._out_of_band(r):
                        if not drifted and source != "trace":
                            source = "telemetry"
                        drifted = True
            term = worst_term if self._out_of_band(worst) else ""
            ratio = worst
            # measured per-mode timings trump everything for overlap
            # pins: the chosen mode losing to a measured alternative by
            # more than the margin is drift, no table inference needed
            if overlap_timings is not None and d.strategy.startswith(
                "overlap/mode="
            ):
                modes = overlap_timings.get(d.fingerprint) or {}
                chosen = d.strategy.split("=", 1)[1]
                t_chosen = modes.get(chosen, 0.0)
                alternatives = [
                    t for m, t in modes.items()
                    if m not in (chosen, "off") and t > 0.0
                ]
                if t_chosen > 0.0 and alternatives:
                    r = t_chosen / min(alternatives)
                    obs_ratio = r
                    obs_mean = t_chosen
                    if r > overlap_margin:
                        drifted = True
                        source = "telemetry"
                        term, ratio = "overlap", r
            # a varlen pin's premise is its probed compression ratio:
            # the achieved-ratio ring decaying past the margin means the
            # compressed bytes on the wire grew past what was priced
            if telemetry is not None and d.strategy == "wire/varlen":
                pinned = _pinned_ratio(d.signature)
                ring = telemetry.get(f"{d.fingerprint}/ratio")
                if (
                    pinned
                    and ring is not None
                    and ring.count >= self.min_samples
                    and ring.mean > 0.0
                ):
                    r = ring.mean / pinned
                    obs_mean = ring.mean
                    obs_ratio = r
                    samples = ring.count
                    if r > compress_margin:
                        drifted = True
                        source = "telemetry"
                        term, ratio = "compress", r
            findings.append(
                DriftFinding(
                    fingerprint=d.fingerprint,
                    strategy=d.strategy,
                    term=term,
                    ratio=ratio,
                    drifted=drifted,
                    source=source,
                    recorded_total=d.total,
                    repriced_total=repriced,
                    observed_mean=obs_mean,
                    observed_ratio=obs_ratio,
                    samples=samples,
                    signature=d.signature,
                    phase_ratios=dict(sorted(phase_ratios.items())),
                )
            )
        report = DriftReport(
            system=system,
            threshold=self.threshold,
            min_samples=self.min_samples,
            term_ratios=ratios,
            findings=tuple(findings),
        )
        from repro_torch.obs.metrics import default_metrics

        default_metrics().inc("drift.findings", len(report.findings))
        default_metrics().inc("drift.drifted", report.drifted_count)
        return report


def remeasure_term(
    params: SystemParams,
    term: str,
    reduced: bool = True,
    iters: Optional[int] = None,
    measured: Optional[dict] = None,
    device="cuda",
) -> SystemParams:
    """Targeted re-measurement: re-run ONLY the drifted term's sweep and
    splice the fresh table into ``params``, leaving every other measured
    term untouched — the surgical response a :class:`DriftReport`
    prescribes (a full ``calibrate_params`` re-run would throw away
    every still-valid table with it).

    ``measured`` injects pre-computed sweep output keyed by the
    SystemParams field names (tests and offline replays); by default the
    sweep runs through :mod:`repro_torch.measure.bench` on ``device``
    (the card unless ``device="cpu"``).
    """
    if term not in TERMS:
        raise ValueError(f"unknown term {term!r}; expected one of {TERMS}")
    from repro_torch.measure import bench

    totals = bench.REDUCED_TOTAL_BYTES if reduced else bench.TOTAL_BYTES
    blocks = bench.REDUCED_BLOCK_BYTES if reduced else bench.BLOCK_BYTES
    radii = bench.REDUCED_STENCIL_RADII if reduced else bench.STENCIL_RADII
    kw = dict(iters=iters if iters is not None else (2 if reduced else 5), device=device)

    updates: Dict[str, object] = {}
    if measured is not None:
        updates = dict(measured)
    elif term == "wire":
        rows = bench.measure_wire_table(totals, **kw)
        lat, bw = bench.fit_latency_bandwidth(rows)
        updates = {"wire_table": tuple(rows), "wire_latency": lat, "wire_bw": bw}
    elif term == "pack_unpack":
        pack = bench.measure_pack_table(None, blocks, totals, **kw)
        unpack = bench.measure_unpack_table(None, blocks, totals, **kw)
        updates = {
            "pack_table": {k: tuple(v) for k, v in pack.items() if v},
            "unpack_table": {k: tuple(v) for k, v in unpack.items() if v},
        }
    elif term == "stencil":
        rows = bench.measure_stencil_table(radii, totals, **kw)
        updates = {"stencil_table": tuple(rows)}
    elif term == "copy":
        rows = bench.measure_copy_table(totals, **kw)
        updates = {"copy_table": tuple(rows)}
    elif term == "compress":
        table = bench.measure_compress_table(total_bytes=totals, **kw)
        updates = {"compress_table": {k: tuple(v) for k, v in table.items() if v}}
    return dataclasses.replace(params, **updates)


def demote_stale_modes(decisions, report: DriftReport) -> List[str]:
    """Delete every ``overlap/mode=`` decision row the ``report``
    flagged as drifted, so the next smoother pass re-measures and
    re-records instead of replaying a pin the measurements contradict.

    Returns the ``"strategy@fingerprint"`` labels of the demoted rows.
    The ``"overlap"`` term is *not* in :data:`TERMS` on purpose: no
    calibration sweep re-measures an overlap trade — demotion followed
    by a smoother re-run is the targeted response.
    """
    stale = {
        f.fingerprint
        for f in report.drifted
        if f.strategy.startswith("overlap/mode=")
    }
    dropped = decisions.prune(
        lambda d: d.strategy.startswith("overlap/mode=")
        and d.fingerprint in stale
    )
    return [f"{d.strategy}@{d.fingerprint}" for d in dropped]


def demote_stale_compress(decisions, report: DriftReport) -> List[str]:
    """Delete every ``wire/varlen`` schedule pin the ``report`` flagged
    for compression-ratio drift (``term="compress"``), plus every probed
    compressed *selection* row (a strategy row whose signature carries
    ``stream_bytes=``) — the selection pins share the drifted schedule's
    premise (the probed ratio) but live under the datatype fingerprint,
    not the plan fingerprint, so they cannot be joined row-for-row.  The
    next planning pass re-probes the actual payload and re-records both.

    Returns the ``"strategy@fingerprint"`` labels of the demoted rows.
    """
    stale = {
        f.fingerprint
        for f in report.drifted
        if f.strategy == "wire/varlen" and f.term == "compress"
    }
    if not stale:
        return []
    dropped = decisions.prune(
        lambda d: (d.strategy == "wire/varlen" and d.fingerprint in stale)
        or (
            not d.strategy.startswith(("wire/", "overlap/", "program/"))
            and " stream_bytes=" in f" {d.signature}"
        )
    )
    return [f"{d.strategy}@{d.fingerprint}" for d in dropped]
