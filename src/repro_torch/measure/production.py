"""Production wiring: measured params plus pinned decisions.

The §6.3 lifecycle for a long-running job in one call: the first run
calibrates (or loads an earlier calibration for this system fingerprint)
and records every strategy selection it makes; the decisions file is
saved at the store's root, so every later run of the job **pins** those
selections and never consults the model for them again.

    comm, save = production_communicator()
    ... every datatype exchange of the job goes through comm ...
    save()          # persist the (possibly grown) decisions file

With ``telemetry=True`` the communicator also carries an
:class:`~repro_torch.fleet.telemetry.ExchangeTelemetry` probe whose
aggregates persist to ``telemetry.json`` next to the decisions file on
``save()``, and with ``tracer=True`` a :class:`~repro_torch.obs.Tracer`
records the exchange spans (export them with
:func:`repro_torch.obs.export.save_chrome_trace`).  ``save()`` also
writes a ``metrics.json`` snapshot of the communicator's counters.
``python -m repro_torch.fleet report`` / ``stats`` render them, and
:mod:`repro_torch.fleet.drift` audits them.
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
    telemetry: ``True`` loads (or starts) the store's runtime telemetry
        (``telemetry.json``, persisted by ``save()`` beside the
        decisions); an :class:`~repro_torch.fleet.telemetry.ExchangeTelemetry`
        instance is attached as-is (the caller owns its persistence);
        ``None``/``False`` attaches no probe.
    tracer: ``True`` attaches a fresh :class:`repro_torch.obs.Tracer`; a
        Tracer instance is attached as-is; ``None``/``False`` attaches
        none.
    transport: what moves the wire bytes (default: the local mesh on
        ``device``).  Under one process per rank
        (:class:`~repro_torch.comm.distributed.DistributedTransport`) the
        device is the transport's, and every rank must load the same
        tables: calibrate once beforehand, or pass ``params``.

    Returns ``(comm, save)``: ``save()`` writes the decisions file, the
    store-owned telemetry and the ``metrics.json`` snapshot
    (:func:`repro_torch.obs.metrics.publish_comm_stats`); under one
    process per rank only rank 0 writes them (the others return the
    decisions file's path).
    """
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
    tel = tel_path = None
    if telemetry is True:
        from repro_torch.fleet.telemetry import TELEMETRY_FILENAME, ExchangeTelemetry

        tel_path = store.root / TELEMETRY_FILENAME
        tel = ExchangeTelemetry.load(tel_path)
    elif telemetry is not None and telemetry is not False:
        # an instance, attached even while empty: an empty registry is
        # falsy (it has a length), which the reference's ``elif
        # telemetry:`` takes for "no probe"
        tel = telemetry
    tr = None
    if tracer is True:
        from repro_torch.obs.trace import Tracer

        tr = Tracer()
    elif tracer is not None and tracer is not False:  # an instance, even an empty one
        tr = tracer
    comm = Communicator(params=params, decisions=decisions, device=dev, transport=transport,
                        topology=topology, telemetry=tel, tracer=tr)

    def save() -> Path:
        if comm.transport.rank != 0:
            return decisions_path
        if tel_path is not None:
            tel.save(tel_path)
        from repro_torch.obs.metrics import METRICS_FILENAME, default_metrics

        comm.stats()  # publish the latest counters into the registry
        default_metrics().save(store.root / METRICS_FILENAME)
        return decisions.save(decisions_path)

    return comm, save
