"""Versioned on-disk SystemParams database (paper §6.3: measurements are
recorded once to the file system and reused by every later run).

Layout: one JSON file per system fingerprint under a root directory
(``$REPRO_TORCH_MEASURE_DIR`` or ``~/.cache/repro_torch/measure``; never
the reference's root, since the decisions file beside the envelopes is
keyed by type fingerprint alone).  Each file is the reference's
envelope, with the reference's field names in ``params``::

    {
      "format": 6,                       # store format version
      "system": "<system fingerprint>",  # what the tables were taken on
      "system_description": [...],       # human-readable provenance
      "params": { ... SystemParams ... }
    }

so ``repro.measure.ParamsStore.read_envelope`` reads a file this module
wrote, and this module reads the reference's.  :meth:`ParamsStore.load`
refuses other format versions and foreign system fingerprints, so a
store never serves numbers measured on other hardware or for another
rank count.  :func:`load_or_calibrate` reads the stored tables for this
system, or calibrates once and stores them.

The tables measured on one H100 are checked in as ``h100_params.json``
next to this module (:func:`load_h100_params`), and a reduced-grid CPU
calibration as ``ci_params.json`` (:func:`load_ci_params`).
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional, Union

from repro_torch.comm.perfmodel import SystemParams
from repro_torch.measure.bench import RANKS, calibrate_params
from repro_torch.measure.fingerprint import system_description, system_fingerprint

__all__ = [
    "STORE_FORMAT",
    "COMPATIBLE_FORMATS",
    "ParamsStore",
    "default_store",
    "load_or_calibrate",
    "ci_params_path",
    "h100_params_path",
    "load_ci_params",
    "load_h100_params",
]

#: the reference's envelope format
STORE_FORMAT = 6

#: formats the reader understands: the reference's formats 2-5 differ
#: from 6 only in optional tables this slice either reads or refuses
COMPATIBLE_FORMATS = (2, 3, 4, 5, STORE_FORMAT)

_ENV_ROOT = "REPRO_TORCH_MEASURE_DIR"


class ParamsStore:
    """A directory of system-fingerprint-keyed SystemParams envelopes
    for tables measured at ``ranks`` local-mesh ranks on ``device`` (the
    card unless ``device="cpu"``)."""

    def __init__(self, root: Optional[Union[str, Path]] = None, *,
                 ranks: int = RANKS, device="cuda"):
        if root is None:
            root = os.environ.get(_ENV_ROOT) or (
                Path.home() / ".cache" / "repro_torch" / "measure"
            )
        self.root = Path(root)
        self.ranks = ranks
        self.device = device

    def system(self) -> str:
        """Fingerprint of the system this store measures and serves."""
        return system_fingerprint(self.ranks, self.device)

    def path_for(self, system: Optional[str] = None) -> Path:
        return self.root / f"{system or self.system()}.json"

    # -- write ----------------------------------------------------------
    def save(
        self,
        params: SystemParams,
        system: Optional[str] = None,
        path: Optional[Union[str, Path]] = None,
    ) -> Path:
        system = system or self.system()
        envelope = {
            "format": STORE_FORMAT,
            "system": system,
            "system_description": list(system_description(self.ranks, self.device)),
            "params": json.loads(params.to_json()),
        }
        out = Path(path) if path is not None else self.path_for(system)
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(".tmp")
        tmp.write_text(json.dumps(envelope, indent=2))
        tmp.replace(out)  # atomic: concurrent readers never see a torn file
        return out

    # -- read -----------------------------------------------------------
    @staticmethod
    def _parse(path: Union[str, Path]):
        """One envelope file -> (SystemParams, system fingerprint), or
        (None, None) when missing or of a foreign format.  Bare
        SystemParams JSON is accepted too (its system is None)."""
        p = Path(path)
        if not p.exists():
            return None, None
        d = json.loads(p.read_text())
        system = None
        if "params" in d:
            if d.get("format") not in COMPATIBLE_FORMATS:
                return None, None
            system = d.get("system")
            d = d["params"]
        if "name" not in d:
            return None, None
        return SystemParams.from_reference(**d), system

    @staticmethod
    def read_envelope(path: Union[str, Path]) -> Optional[SystemParams]:
        """Parse one envelope file whichever system recorded it; None
        when missing or of a foreign format."""
        return ParamsStore._parse(path)[0]

    def load(self, system: Optional[str] = None) -> Optional[SystemParams]:
        """Stored params for ``system`` (default: this store's system),
        or None when absent, of a foreign format, or recorded for a
        different system fingerprint."""
        system = system or self.system()
        params, recorded = self._parse(self.path_for(system))
        if params is None or recorded != system:
            return None
        return params

    def load_or_calibrate(
        self,
        name: Optional[str] = None,
        reduced: bool = False,
        force: bool = False,
    ) -> SystemParams:
        """The §6.3 lifecycle in one call: reuse the stored measurement
        for this system, or calibrate once and store it."""
        if not force:
            got = self.load()
            if got is not None:
                return got
        params = calibrate_params(name=name, reduced=reduced, ranks=self.ranks,
                                  device=self.device)
        self.save(params)
        return params


def default_store(ranks: int = RANKS, device="cuda") -> ParamsStore:
    """Store rooted at ``$REPRO_TORCH_MEASURE_DIR`` (or the user cache)."""
    return ParamsStore(ranks=ranks, device=device)


def load_or_calibrate(
    name: Optional[str] = None, reduced: bool = False, force: bool = False,
    ranks: int = RANKS, device="cuda",
) -> SystemParams:
    """Module-level shorthand over :meth:`ParamsStore.load_or_calibrate`."""
    return default_store(ranks, device).load_or_calibrate(name, reduced, force)


def h100_params_path() -> Path:
    """The checked-in full-grid calibration of one H100 at 8 ranks."""
    return Path(__file__).parent / "h100_params.json"


def load_h100_params() -> SystemParams:
    params = ParamsStore.read_envelope(h100_params_path())
    if params is None:
        raise FileNotFoundError(
            f"checked-in H100 params missing or unreadable: {h100_params_path()}"
        )
    return params


def ci_params_path() -> Path:
    """The checked-in reduced-grid CPU calibration that pins CI selection
    decisions: the port's own, written by ``python -m repro_torch.measure
    --reduced --device cpu``."""
    return Path(__file__).parent / "ci_params.json"


def load_ci_params() -> SystemParams:
    params = ParamsStore.read_envelope(ci_params_path())
    if params is None:
        raise FileNotFoundError(
            f"checked-in CI params missing or unreadable: {ci_params_path()}"
        )
    return params
