"""Production wiring: measured params plus pinned decisions.

The §6.3 lifecycle for a long-running job in one call: the first run
calibrates (or loads an earlier calibration for this system fingerprint)
and records every strategy selection it makes; the decisions file is
saved at the store's root, so every later run of the job **pins** those
selections and never consults the model for them again.

    comm, save = production_communicator()
    ... every datatype exchange of the job goes through comm ...
    save()          # persist the (possibly grown) decisions file
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional, Tuple, Union

from repro_torch.comm.api import Communicator
from repro_torch.comm.perfmodel import H100_ANALYTIC, SystemParams
from repro_torch.device import resolve_device
from repro_torch.measure.bench import RANKS
from repro_torch.measure.decisions import DecisionCache
from repro_torch.measure.store import ParamsStore

__all__ = ["DECISIONS_FILENAME", "production_communicator"]

#: the decisions file lives at the root of the params store
DECISIONS_FILENAME = "decisions.json"

#: reference options whose machinery is a later roadmap item
_LATER = {
    "telemetry": "Queue 1, observability and fleet",
    "tracer": "Queue 1, observability and fleet",
}


def production_communicator(
    cache_dir: Optional[Union[str, Path]] = None,
    *,
    calibrate: bool = True,
    reduced: Optional[bool] = None,
    params: Optional[SystemParams] = None,
    ranks: int = RANKS,
    device=None,
    telemetry=None,
    tracer=None,
    halo_steps=None,
    topology=None,
    transport=None,
) -> Tuple[Communicator, Callable[[], Path]]:
    """A :class:`Communicator` wired for production reuse.

    Parameters
    ----------
    cache_dir: params-store root (default: ``$REPRO_TORCH_MEASURE_DIR``
        or the user cache dir).
    calibrate: when True (default), a missing calibration for this
        system fingerprint is measured once and stored; when False, a
        missing calibration falls back to the analytic table.
    reduced: grid size of a fresh calibration; defaults to the full grid
        on the card and the reduced one on the CPU.
    params: explicit SystemParams (skips the store's tables).
    ranks: the local-mesh rank count the tables are measured for.
    device: ``"cuda"`` (the default; raises without a card) or ``"cpu"``;
        with a transport given, the transport's device (one that differs
        raises).
    halo_steps: when given (``"auto"`` or an int), installs the
        process-wide deep-halo fusion-depth default
        (:func:`repro_torch.halo.program.set_default_halo_steps`) beside
        the decisions cache that pins ``"auto"``, so every
        :func:`~repro_torch.halo.program.build_halo_program` of the job
        resolves its depth through it and records it in the same file.
    topology: a :class:`repro_torch.comm.topology.Topology` rank -> node
        map: the communicator prices the two link tiers apart, may pick
        the ``tiered`` schedule, and keys its wire and program decisions
        by the topology fingerprint, so a pin never replays across a
        reshape.
    telemetry, tracer: the reference's options of a later roadmap item;
        passing one raises NotImplementedError.
    transport: what moves the wire bytes (default: the local mesh on
        ``device``).  Under one process per rank
        (:class:`~repro_torch.comm.distributed.DistributedTransport`) the
        device is the transport's, and every rank must load the same
        tables: calibrate once beforehand, or pass ``params``.

    Returns ``(comm, save)``: ``save()`` writes the decisions file; under
    one process per rank only rank 0 writes it (the others return its
    path).
    """
    for opt, value in (("telemetry", telemetry), ("tracer", tracer)):
        if value is not None and value is not False:
            raise NotImplementedError(
                f"production_communicator({opt}=...) is not ported yet "
                f"(ROADMAP {_LATER[opt]})"
            )
    if halo_steps is not None:
        from repro_torch.halo.program import set_default_halo_steps

        set_default_halo_steps(halo_steps)
    if transport is None:
        dev = resolve_device("cuda" if device is None else device)
    else:
        dev = transport.device
        if device is not None and resolve_device(device) != dev:
            raise ValueError(f"device {device!r} differs from the transport's {dev}")
    store = ParamsStore(cache_dir, ranks=ranks, device=dev)
    if params is None:
        if calibrate:
            if reduced is None:
                reduced = dev.type != "cuda"
            params = store.load_or_calibrate(reduced=reduced)
        else:
            params = store.load() or H100_ANALYTIC
    decisions_path = store.root / DECISIONS_FILENAME
    decisions = DecisionCache.load(decisions_path)
    comm = Communicator(params=params, decisions=decisions, device=dev, transport=transport,
                        topology=topology)

    def save() -> Path:
        if comm.transport.rank != 0:
            return decisions_path
        return decisions.save(decisions_path)

    return comm, save
