"""Versioned decision bundles: rollout semantics for ``decisions.json``,
transcribed from the reference's ``repro.fleet.bundle``.  The port's
:class:`~repro_torch.measure.decisions.Decision` has the reference's
fields in the reference's order, so a bundle, a merge and a diff
serialize to the same bytes in either package.

A raw :class:`~repro_torch.measure.decisions.DecisionCache` file is what one
process recorded — fine for one host, but a fleet needs to move
decisions around: merge what N hosts learned, inspect what changed
between two generations, stage a re-measured set next to the live one
and promote (or roll back) deliberately.  A :class:`DecisionBundle` is
the unit of that motion: a generation-numbered envelope wrapping a
``DecisionCache`` plus provenance (which system fingerprint recorded
it, which params store format priced it, which host), so a bundle can
never silently masquerade as measurements it is not.

Merge is **deterministic and commutative**: the same input bundles in
any order produce byte-identical output.  Conflicts (two bundles
pinning the same decision key to different rows) are resolved by an
*explicit* policy —

``newest-generation``
    the row from the highest-generation bundle wins (a re-measured
    rollout supersedes the old pin);
``lowest-price``
    the row with the lowest recorded total price wins (optimistic
    best-of-fleet; safe only across same-hardware hosts).

Both policies break remaining ties identically (lower price, then the
lexicographically smaller serialized row), so no input ordering can
leak into the result.  ``diff`` output is canonical JSON (sorted keys,
sorted rows) and round-trips byte-identically.  ``promote`` installs a
bundle's decisions as the live engine file with a ``.prev`` backup;
``rollback`` swaps the backup straight back.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple, Union

from repro_torch.measure.decisions import (
    DECISIONS_FORMAT,
    Decision,
    DecisionCache,
    Key,
)
from repro_torch.measure.store import STORE_FORMAT

__all__ = [
    "BUNDLE_FORMAT",
    "CONFLICT_POLICIES",
    "DecisionBundle",
    "load_bundle",
    "merge_bundles",
    "diff_bundles",
    "promote",
    "rollback",
]

#: bump when the bundle envelope schema changes incompatibly
BUNDLE_FORMAT = 1

#: explicit conflict policies for :func:`merge_bundles`
CONFLICT_POLICIES = ("newest-generation", "lowest-price")


def _row_sort_key(d: Decision) -> tuple:
    return (d.fingerprint, d.incount, d.hops, d.allow_bounding, d.strategy)


def _canonical_row(d: Decision) -> str:
    """Canonical serialized form of one decision row — the final merge
    tie-break, so two rows compare identically on every host."""
    return json.dumps(dataclasses.asdict(d), sort_keys=True)


@dataclass
class DecisionBundle:
    """Generation-numbered, provenance-stamped ``DecisionCache``."""

    decisions: DecisionCache
    generation: int = 0
    system: str = ""         # system fingerprint that recorded the rows
    params_format: int = STORE_FORMAT
    host: str = ""           # free-form origin label (hostname, CI run id)
    #: topology fingerprint the rows were planned under ("" = flat /
    #: unknown) — wire-schedule and fusion-depth rows recorded on a
    #: 2-level machine must not be promoted onto a different shape, so
    #: bundles carry the rank->node map's identity alongside the
    #: system's (optional envelope key; format stays 1)
    topology: str = ""

    # -- persistence -----------------------------------------------------
    def to_json(self) -> str:
        """Canonical form: sorted envelope keys, key-sorted rows — two
        bundles with the same content serialize byte-identically
        regardless of recording order."""
        return json.dumps(
            {
                "bundle_format": BUNDLE_FORMAT,
                "decisions_format": DECISIONS_FORMAT,
                "generation": self.generation,
                "host": self.host,
                "params_format": self.params_format,
                "system": self.system,
                "topology": self.topology,
                "rows": [
                    dataclasses.asdict(d)
                    for d in sorted(self.decisions.log, key=_row_sort_key)
                ],
            },
            sort_keys=True,
            indent=2,
        )

    @staticmethod
    def from_json(s: str) -> "DecisionBundle":
        d = json.loads(s)
        if d.get("bundle_format") != BUNDLE_FORMAT:
            raise ValueError(
                f"bundle format {d.get('bundle_format')!r} != {BUNDLE_FORMAT}"
            )
        if d.get("decisions_format") != DECISIONS_FORMAT:
            raise ValueError(
                f"bundled decisions format {d.get('decisions_format')!r} != "
                f"{DECISIONS_FORMAT}; re-record or migrate"
            )
        return DecisionBundle(
            decisions=DecisionCache(
                [Decision(**row) for row in d.get("rows", ())]
            ),
            generation=int(d.get("generation", 0)),
            system=d.get("system", ""),
            params_format=int(d.get("params_format", STORE_FORMAT)),
            host=d.get("host", ""),
            topology=d.get("topology", ""),
        )

    def save(self, path: Union[str, Path]) -> Path:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.with_suffix(".tmp")
        tmp.write_text(self.to_json())
        tmp.replace(p)
        return p

    def summary(self) -> str:
        return (
            f"bundle gen={self.generation} system={self.system or '-'}"
            f" host={self.host or '-'} params_format={self.params_format}"
            f" topo={self.topology or '-'} rows={len(self.decisions)}"
        )


def load_bundle(path: Union[str, Path]) -> DecisionBundle:
    """Load a bundle file — or a raw engine ``decisions.json``, which is
    auto-wrapped as a generation-0 bundle (so ``merge``/``diff`` accept
    what :func:`~repro_torch.measure.production.production_communicator`
    writes without a separate conversion step)."""
    p = Path(path)
    d = json.loads(p.read_text())
    if "bundle_format" in d:
        return DecisionBundle.from_json(p.read_text())
    # raw DecisionCache file (validates its own format field)
    return DecisionBundle(decisions=DecisionCache.from_json(p.read_text()))


def _pick(
    a: Tuple[int, Decision], b: Tuple[int, Decision], policy: str
) -> Tuple[int, Decision]:
    """Resolve one key conflict between (generation, row) pairs.  Total
    order: policy criterion, then lower price, then canonical-JSON — so
    the pick is independent of argument order."""
    (ga, da), (gb, db) = a, b
    if policy == "newest-generation":
        if ga != gb:
            return a if ga > gb else b
    elif policy == "lowest-price":
        if da.total != db.total:
            return a if da.total < db.total else b
        if ga != gb:            # same price: prefer the newer provenance
            return a if ga > gb else b
    else:
        raise ValueError(
            f"unknown conflict policy {policy!r}; expected one of "
            f"{CONFLICT_POLICIES}"
        )
    if da.total != db.total:    # newest-generation tie: cheaper row
        return a if da.total < db.total else b
    return a if _canonical_row(da) <= _canonical_row(db) else b


def merge_bundles(
    bundles: Sequence[DecisionBundle],
    policy: str = "newest-generation",
    generation: Optional[int] = None,
    host: str = "",
) -> DecisionBundle:
    """Deterministic union of N bundles under ``policy``.

    The output generation defaults to ``max(input generations) + 1`` —
    a merge is a new rollout, not a re-label.  Output rows are
    key-sorted; merging the same bundles in any order yields
    byte-identical JSON.  System/params provenance carries through only
    when unanimous (a cross-system merge stamps neither fingerprint —
    the bundle says so rather than lying about where its numbers came
    from).
    """
    if not bundles:
        raise ValueError("merge_bundles needs at least one bundle")
    if policy not in CONFLICT_POLICIES:
        raise ValueError(
            f"unknown conflict policy {policy!r}; expected one of "
            f"{CONFLICT_POLICIES}"
        )
    chosen: Dict[Key, Tuple[int, Decision]] = {}
    for b in bundles:
        for d in b.decisions.log:
            cur = chosen.get(d.key)
            cand = (b.generation, d)
            chosen[d.key] = cand if cur is None else _pick(cur, cand, policy)
    rows = sorted((d for _, d in chosen.values()), key=_row_sort_key)
    systems = {b.system for b in bundles}
    formats = {b.params_format for b in bundles}
    topologies = {b.topology for b in bundles}
    return DecisionBundle(
        decisions=DecisionCache(rows),
        generation=(
            generation if generation is not None
            else max(b.generation for b in bundles) + 1
        ),
        system=systems.pop() if len(systems) == 1 else "",
        params_format=formats.pop() if len(formats) == 1 else 0,
        host=host,
        # same unanimity rule as system: a cross-topology merge stamps
        # no fingerprint rather than claiming a shape it wasn't on
        topology=topologies.pop() if len(topologies) == 1 else "",
    )


def diff_bundles(a: DecisionBundle, b: DecisionBundle) -> dict:
    """Canonical diff ``a -> b``: added / removed / changed rows, every
    list key-sorted.  ``json.dumps(diff, sort_keys=True, indent=2)``
    round-trips byte-identically (the CI gate serializes it twice and
    compares bytes)."""
    rows_a = {d.key: d for d in a.decisions.log}
    rows_b = {d.key: d for d in b.decisions.log}
    added = [rows_b[k] for k in rows_b.keys() - rows_a.keys()]
    removed = [rows_a[k] for k in rows_a.keys() - rows_b.keys()]
    changed = [
        {
            "before": dataclasses.asdict(rows_a[k]),
            "after": dataclasses.asdict(rows_b[k]),
        }
        for k in sorted(
            rows_a.keys() & rows_b.keys(),
            key=lambda k: _row_sort_key(rows_a[k]),
        )
        if rows_a[k] != rows_b[k]
    ]
    return {
        "generation_from": a.generation,
        "generation_to": b.generation,
        "added": [
            dataclasses.asdict(d) for d in sorted(added, key=_row_sort_key)
        ],
        "removed": [
            dataclasses.asdict(d) for d in sorted(removed, key=_row_sort_key)
        ],
        "changed": changed,
    }


def _prev_path(live: Path) -> Path:
    return live.with_name(live.name + ".prev")


def promote(
    bundle: DecisionBundle, live_path: Union[str, Path]
) -> Tuple[Path, Optional[Path]]:
    """Install ``bundle``'s decisions as the live engine file.

    Writes the raw ``DecisionCache`` JSON (exactly what
    ``production_communicator`` loads) to ``live_path`` after backing up
    any existing live file to ``<live_path>.prev``; the full bundle
    envelope is kept alongside as ``<live_path>.bundle`` so provenance
    survives promotion.  Returns ``(live, backup-or-None)``.
    """
    live = Path(live_path)
    live.parent.mkdir(parents=True, exist_ok=True)
    backup = None
    if live.exists():
        backup = _prev_path(live)
        backup.write_text(live.read_text())
    bundle.decisions.save(live)
    live.with_name(live.name + ".bundle").write_text(bundle.to_json())
    return live, backup


def rollback(live_path: Union[str, Path]) -> Path:
    """Undo the last :func:`promote`: restore ``<live_path>.prev``."""
    live = Path(live_path)
    backup = _prev_path(live)
    if not backup.exists():
        raise FileNotFoundError(
            f"no {backup} to roll back to — nothing was promoted here"
        )
    live.write_text(backup.read_text())
    return live
