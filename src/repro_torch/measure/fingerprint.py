"""Stable content fingerprints for measurement and selection caches.

Measured system parameters are recorded to the file system once and
reused across runs (paper §6.3), so every key must outlive the process
that made it:

* **datatype fingerprint** — :func:`type_fingerprint` is the committed
  type's hash of its canonical structure (``CommittedType.fingerprint``).
  It equals the reference's for the same description, which is what lets
  one decisions file serve both packages.
* **system fingerprint** — :func:`system_fingerprint` hashes what a
  calibration was taken on: platform, device name, the local-mesh rank
  count every launch of the sweep served, and the torch version.  A
  params store never serves numbers measured on other hardware or for
  another batch of ranks.
"""

from __future__ import annotations

import hashlib
from typing import Tuple

import torch

from repro_torch.core.commit import CommittedType
from repro_torch.device import resolve_device

__all__ = [
    "type_fingerprint",
    "system_fingerprint",
    "system_description",
    "FINGERPRINT_BYTES",
]

#: hex digits kept from the sha256 (the reference's key length)
FINGERPRINT_BYTES = 16


def type_fingerprint(ct: CommittedType) -> str:
    """Content hash of a committed type's canonical structure."""
    return ct.fingerprint


def system_description(ranks: int = 8, device="cuda") -> Tuple[str, ...]:
    """``(platform, device name, ranks, torch version)`` of the system a
    calibration runs on: ``("cuda", <card name>, "8", ...)`` on the card,
    ``("cpu", "cpu", ...)`` on the host.  ``ranks`` is the local-mesh
    rank count the tables are measured for."""
    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return (dev.type, name, str(int(ranks)), torch.__version__)


def system_fingerprint(ranks: int = 8, device="cuda") -> str:
    """Stable hash of :func:`system_description` — the key a stored
    :class:`~repro_torch.comm.perfmodel.SystemParams` lives under."""
    desc = "/".join(system_description(ranks, device))
    return hashlib.sha256(desc.encode()).hexdigest()[:FINGERPRINT_BYTES]
