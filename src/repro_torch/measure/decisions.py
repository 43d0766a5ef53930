"""Persistent strategy-selection cache and audit log.

The paper's selection is a pure function of (datatype, system
parameters), memoized per committed type (§6.3).  This module makes the
decisions durable: every selection a
:class:`~repro_torch.comm.perfmodel.PerfModel` makes is recorded as a
:class:`Decision` keyed by the datatype's content fingerprint, saved to
JSON, reloaded in a fresh process and handed back to a model
(``PerfModel(params, decisions=...)``), which then *pins* the recorded
strategy instead of re-deriving it.

The file format is the reference's (``repro.measure.decisions``), byte
for byte, so each package reads and pins the other's file.
:meth:`DecisionCache.report` dumps the audit log.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

from repro_torch.comm.perfmodel import StrategyEstimate

__all__ = ["Decision", "DecisionCache", "DECISIONS_FORMAT", "describe_type"]

#: bump when Decision's schema changes incompatibly (the reference's too)
DECISIONS_FORMAT = 1

Key = Tuple[str, int, int, bool]


@dataclass(frozen=True)
class Decision:
    """One audited strategy selection."""

    fingerprint: str        # CommittedType content hash
    incount: int
    hops: int
    allow_bounding: bool
    strategy: str           # the winner
    t_pack: float           # estimated terms at decision time (seconds)
    t_link: float
    t_unpack: float
    signature: str = ""     # human-readable datatype description
    wire_bytes: int = 0     # exact bytes the choice puts on the wire

    @property
    def total(self) -> float:
        return self.t_pack + self.t_link + self.t_unpack

    @property
    def key(self) -> Key:
        return (self.fingerprint, self.incount, self.hops, self.allow_bounding)


def describe_type(ct) -> str:
    """Short human-readable signature of a committed type for the audit
    log (the reference's text)."""
    if ct is None:
        return ""
    b = ct.block
    if b is None:
        return f"{ct.kernel.value} size={ct.size} extent={ct.extent}"
    return (
        f"{ct.kernel.value} counts={list(b.counts)} strides={list(b.strides)}"
        f" size={ct.size}"
    )


class DecisionCache:
    """Fingerprint-keyed decision store: lookup/record for the model,
    load/save for persistence, report() for the audit dump."""

    def __init__(self, decisions: Optional[List[Decision]] = None):
        self._by_key: Dict[Key, Decision] = {}
        self.log: List[Decision] = []          # insertion-ordered audit trail
        self._log_index: Dict[Key, int] = {}   # key -> position in the log
        self.pinned_hits = 0                   # lookups served from the cache
        for d in decisions or ():
            self._insert(d)

    def _insert(self, d: Decision) -> None:
        # last wins per key, in place, so record -> save -> load -> record
        # cycles never grow duplicate rows in the persisted log
        k = d.key
        at = self._log_index.get(k)
        if at is None:
            self._log_index[k] = len(self.log)
            self.log.append(d)
        else:
            self.log[at] = d
        self._by_key[k] = d

    # -- model-facing ----------------------------------------------------
    def lookup(
        self, fingerprint: str, incount: int, hops: int, allow_bounding: bool
    ) -> Optional[Decision]:
        d = self._by_key.get((fingerprint, incount, hops, allow_bounding))
        if d is not None:
            self.pinned_hits += 1
        return d

    def record(
        self,
        fingerprint: str,
        incount: int,
        hops: int,
        allow_bounding: bool,
        estimate: StrategyEstimate,
        ct=None,
        signature: Optional[str] = None,
    ) -> Decision:
        d = Decision(
            fingerprint=fingerprint,
            incount=incount,
            hops=hops,
            allow_bounding=allow_bounding,
            strategy=estimate.strategy,
            t_pack=estimate.t_pack,
            t_link=estimate.t_link,
            t_unpack=estimate.t_unpack,
            signature=signature if signature is not None else describe_type(ct),
            wire_bytes=estimate.wire_bytes,
        )
        self._insert(d)
        return d

    # -- persistence -----------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(
            {"format": DECISIONS_FORMAT, "decisions": [asdict(d) for d in self.log]},
            indent=2,
        )

    @staticmethod
    def from_json(s: str) -> "DecisionCache":
        d = json.loads(s)
        if d.get("format") != DECISIONS_FORMAT:
            # refusing loudly beats silently un-pinning every selection
            raise ValueError(
                f"decision file format {d.get('format')!r} != "
                f"{DECISIONS_FORMAT}; re-record or migrate it"
            )
        return DecisionCache([Decision(**row) for row in d["decisions"]])

    def save(self, path: Union[str, Path]) -> Path:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.with_suffix(".tmp")
        tmp.write_text(self.to_json())
        tmp.replace(p)  # atomic: concurrent readers never see a torn file
        return p

    @staticmethod
    def load(path: Union[str, Path]) -> "DecisionCache":
        """Load a saved cache; an absent file yields an empty cache (the
        first run of a job starts cold and records)."""
        p = Path(path)
        if not p.exists():
            return DecisionCache()
        return DecisionCache.from_json(p.read_text())

    # -- maintenance -----------------------------------------------------
    def prune(self, predicate) -> List[Decision]:
        """Remove every row for which ``predicate(decision)`` is true and
        return the removed rows.  A pin whose premise no longer holds (a
        topology that reshaped away) is deleted, so the next planning
        pass re-prices and re-records instead of replaying it."""
        dropped, kept = [], []
        for d in self.log:
            (dropped if predicate(d) else kept).append(d)
        if dropped:
            self._by_key.clear()
            self._log_index.clear()
            self.log = []
            for d in kept:
                self._insert(d)
        return dropped

    def program_rows(self) -> List[Decision]:
        """The deep-halo fusion-depth decisions (``program/s=N`` rows,
        keyed by program fingerprint — one per distinct
        grid/interior/cycle geometry)."""
        return [d for d in self.log if d.strategy.startswith("program/s=")]

    # -- audit -----------------------------------------------------------
    def report(self) -> str:
        """The audit log as aligned text: one selection per line."""
        lines = [
            f"{'fingerprint':16s}  {'n':>3s} {'hop':>3s} {'strategy':12s}"
            f" {'t_pack_us':>10s} {'t_link_us':>10s} {'t_unpack_us':>11s}"
            f" {'total_us':>10s} {'wire_B':>10s}  signature"
        ]
        for d in self.log:
            lines.append(
                f"{d.fingerprint:16s}  {d.incount:3d} {d.hops:3d}"
                f" {d.strategy:12s} {d.t_pack * 1e6:10.3f}"
                f" {d.t_link * 1e6:10.3f} {d.t_unpack * 1e6:11.3f}"
                f" {d.total * 1e6:10.3f} {d.wire_bytes:10d}  {d.signature}"
            )
        return "\n".join(lines)

    def __len__(self) -> int:
        return len(self._by_key)
