"""Timed-sweep measurement harness (paper §6.3: "TEMPI provides a binary
that records system performance parameters to the file system.  This
binary should be run once before TEMPI is used in an application.").

The §5 model needs every term of T = T_pack + T_link + T_unpack from
empirical measurement, not data-sheet constants: strategy rankings flip
with block size and object size, per system.  This module measures them
on the running device:

* :func:`measure_pack_table` / :func:`measure_unpack_table` — per
  measurable strategy, over a sparse (contiguous block bytes x object
  bytes) grid of ``Vector(nblocks, blk, pitch, BYTE)`` types, the grid
  the reference sweeps;
* :func:`measure_wire_table` — one ring permutation of the local-mesh
  transport over message sizes, with a least-squares (latency,
  bandwidth) fit (:func:`fit_latency_bandwidth`);
  :func:`measure_wire_tables` the same ring along each axis of a named
  mesh, and :func:`measure_link_class_tables` along each link class of a
  two-level topology;
* :func:`measure_copy_table` — a contiguous read + write over sizes;
* :func:`measure_compress_table` — per wire compressor, the encode and
  decode of a zero-heavy payload timed apart, with the bytes the format
  would move per member byte;
* :func:`measure_stencil_table` — one stencil application
  (:func:`repro_torch.kernels.ops.stencil_window_update`) over (neighbor
  count x window bytes), what the deep-halo programs' redundant compute
  and the overlap modes' regions are priced on.

On the local mesh one launch moves all R ranks, and one wire op moves
every rank's message.  So every sweep runs batched over the same R: each
row is keyed by one rank's bytes and holds the time of the R-rank
launch.  T_pack and T_link are then priced on the same scale, as the
exchange pays them; ``R`` goes into the system description the tables
are stored under.

:func:`calibrate_params` assembles a
:class:`~repro_torch.comm.perfmodel.SystemParams`.  On the card the
strategies run their CUDA kernels; on the host their plain versions.
``reduced=True`` shrinks the grid for CPU tests.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.comm.perfmodel import H100_ANALYTIC, SystemParams
from repro_torch.comm.transport import LocalMeshTransport
from repro_torch.core import BYTE, TypeRegistry, Vector
from repro_torch.device import resolve_device

__all__ = [
    "BLOCK_BYTES",
    "TOTAL_BYTES",
    "REDUCED_BLOCK_BYTES",
    "REDUCED_TOTAL_BYTES",
    "PITCH",
    "RANKS",
    "time_fn",
    "sweep_types",
    "measure_pack_table",
    "measure_unpack_table",
    "measure_wire_table",
    "measure_wire_tables",
    "measure_link_class_tables",
    "measure_copy_table",
    "measure_compress_table",
    "measure_stencil_table",
    "fit_latency_bandwidth",
    "calibrate_params",
]

# the reference's grid (paper Fig. 10 sweeps 64 B - 4 MiB objects over
# block sizes; interpolated at query time)
BLOCK_BYTES: Tuple[int, ...] = (8, 32, 128, 512)
TOTAL_BYTES: Tuple[int, ...] = (1 << 10, 1 << 14, 1 << 18, 1 << 22)
#: the CPU-test grid
REDUCED_BLOCK_BYTES: Tuple[int, ...] = (8, 128)
REDUCED_TOTAL_BYTES: Tuple[int, ...] = (1 << 10, 1 << 14)
PITCH = 512  # paper Fig. 7 uses a 512 B pitch
#: stencil-sweep op shapes: per-dimension radii -> neighbor counts 26,
#: 44 and 124
STENCIL_RADII: Tuple[Tuple[int, int, int], ...] = ((1, 1, 1), (2, 1, 1), (2, 2, 2))
REDUCED_STENCIL_RADII: Tuple[Tuple[int, int, int], ...] = ((1, 1, 1), (2, 1, 1))
#: local-mesh ranks every launch of the sweep serves (the halo's 2x2x2)
RANKS = 8


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(fn, *args, iters: int = 5) -> float:
    """Mean seconds per call of ``iters`` back-to-back calls of ``fn``
    between two synchronizations, after one synchronized warm-up call
    (on the card a launch returns before the device finishes, so an
    unsynchronized warm-up would bleed into the timed calls)."""
    fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync()
    return (time.perf_counter() - t0) / iters


def _resolve_strategies(strategies):
    from repro_torch.comm.api import default_registry, resolve_strategy

    if strategies is None:
        return default_registry().measurable()
    return tuple(resolve_strategy(s) for s in strategies)


def sweep_types(
    block_bytes: Sequence[int], total_bytes: Sequence[int]
) -> Iterable[Tuple[int, int, object]]:
    """(blk, nblocks, committed vector type) over the measurement grid:
    ``nblocks`` blocks of ``blk`` bytes at a pitch of ``max(PITCH,
    2*blk)`` — the reference's shapes, one plane each."""
    reg = TypeRegistry()
    for blk in block_bytes:
        pitch = max(PITCH, 2 * blk)
        for total in total_bytes:
            nblocks = max(total // blk, 1)
            yield blk, nblocks, reg.commit(Vector(nblocks, blk, pitch, BYTE))


def _measure_table(
    make_timed, strategies, block_bytes, total_bytes, iters, ranks, device
) -> Dict[str, List[Tuple[float, float, float]]]:
    """Shared sweep scaffolding for the 2D tables: ``make_timed`` maps
    (strategy, ct, buf) -> (fn, args).  One implementation, so the cap,
    the grid and the row format cannot drift between pack and unpack."""
    dev = resolve_device(device)
    strats = _resolve_strategies(strategies)
    table: Dict[str, List[Tuple[float, float, float]]] = {s.name: [] for s in strats}
    for blk, nblocks, ct in sweep_types(block_bytes, total_bytes):
        buf = torch.zeros((ranks, ct.extent + 64), dtype=torch.uint8, device=dev)
        for s in strats:
            cap = s.calibration_cap
            if cap is not None and nblocks > cap:
                continue  # one host-issued copy per block past the cap
            fn, args = make_timed(s, ct, buf)
            sec = time_fn(fn, *args, iters=iters)
            table[s.name].append((math.log2(blk), math.log2(nblocks * blk), sec))
        del buf
    return table


def measure_pack_table(
    strategies=None,
    block_bytes: Sequence[int] = BLOCK_BYTES,
    total_bytes: Sequence[int] = TOTAL_BYTES,
    iters: int = 5,
    ranks: int = RANKS,
    device="cuda",
) -> Dict[str, List[Tuple[float, float, float]]]:
    """Pack time of every measurable registered strategy (or the given
    strategies/names) over the grid, ``ranks`` ranks per launch."""

    def timed(s, ct, buf):
        return (lambda b: s.pack(b, ct, batched=True)), (buf,)

    return _measure_table(timed, strategies, block_bytes, total_bytes, iters,
                          ranks, device)


def measure_unpack_table(
    strategies=None,
    block_bytes: Sequence[int] = BLOCK_BYTES,
    total_bytes: Sequence[int] = TOTAL_BYTES,
    iters: int = 5,
    ranks: int = RANKS,
    device="cuda",
) -> Dict[str, List[Tuple[float, float, float]]]:
    """Unpack (packed bytes -> strided destination, in place) over the
    same grid as :func:`measure_pack_table`: the paper observes a
    pack/unpack asymmetry, so the model must not derive one from the
    other."""

    def timed(s, ct, buf):
        packed = torch.zeros((buf.shape[0], ct.size), dtype=torch.uint8, device=buf.device)
        return (lambda b, p: s.unpack(b, p, ct, batched=True)), (buf, packed)

    return _measure_table(timed, strategies, block_bytes, total_bytes, iters,
                          ranks, device)


def measure_copy_table(
    total_bytes: Sequence[int] = TOTAL_BYTES,
    iters: int = 5,
    ranks: int = RANKS,
    device="cuda",
) -> List[Tuple[float, float]]:
    """Contiguous device copy time over sizes (a read and a write of
    ``n`` bytes on each of ``ranks`` ranks): the staging floor every
    pack strategy competes with."""
    dev = resolve_device(device)
    rows = []
    for total in total_bytes:
        x = torch.zeros((ranks, total), dtype=torch.uint8, device=dev)
        rows.append((math.log2(total), time_fn(lambda a: a + 1, x, iters=iters)))
    return rows


def measure_compress_table(
    total_bytes: Sequence[int] = TOTAL_BYTES,
    iters: int = 5,
    ranks: int = RANKS,
    device="cuda",
) -> Dict[str, List[Tuple[float, float, float, float]]]:
    """Encode and decode time per wire compressor: rows ``(log2 member
    bytes, encode sec, decode sec, ratio sample)``, ``ranks`` ranks a
    call, the row keyed by one rank's bytes.

    Times each compressor's ``encode_wire`` (member bytes -> wire) and
    ``decode_wire`` (wire -> member bytes) alone: the cost a compressed
    wire adds to the member pack and unpack, the term
    :meth:`~repro_torch.comm.perfmodel.PerfModel.measured_compress`
    interpolates.  The payload is zero-heavy (one byte of 1 per 256), the
    run-length encoder's regime.  The fourth column is what that payload
    gave: the bytes the format would move (its probed stream, else its
    capacity) per member byte; a schedule's ratio comes from a probe of
    its own payload, never from this column.  Swept: ``rlewire`` and
    ``int8wire``, the registered compressors.
    """
    from repro_torch.comm.compress import INT8_WIRE, RLE_WIRE

    dev = resolve_device(device)
    reg = TypeRegistry()
    table: Dict[str, List[Tuple[float, float, float, float]]] = {}
    for s in (RLE_WIRE, INT8_WIRE):
        rows = []
        for total in total_bytes:
            n = max(total - total % 4, 4)  # int8 views member bytes as float32
            member = torch.zeros((ranks, n), dtype=torch.uint8, device=dev)
            member[:, ::256] = 1
            wire = s.encode_wire(member)
            enc = time_fn(s.encode_wire, member, iters=iters)
            dec = time_fn(lambda w, _n=n: s.decode_wire(w, _n), wire, iters=iters)
            ct = reg.commit(Vector(1, n, n, BYTE))  # contiguous: the pack is a copy
            moved = min(s.probe_stream_bytes(ct, 1, member[0]), wire.shape[1])
            rows.append((math.log2(n), enc, dec, moved / float(n)))
            del member, wire
        table[s.name] = rows
    return table


def measure_wire_table(
    total_bytes: Sequence[int] = TOTAL_BYTES,
    iters: int = 5,
    ranks: int = RANKS,
    device="cuda",
) -> List[Tuple[float, float]]:
    """One-hop wire time over message sizes: a ring
    :meth:`~repro_torch.comm.transport.LocalMeshTransport.permute` over
    ``ranks`` ranks, the link the port has.  Rows are (log2 bytes one
    rank sends, sec)."""
    perm = [(i, (i + 1) % ranks) for i in range(ranks)]
    return _time_permutes(perm, total_bytes, iters, ranks, resolve_device(device))


def _time_permutes(perm, total_bytes, iters, ranks, dev) -> List[Tuple[float, float]]:
    """(log2 bytes one rank sends, sec) of one local-mesh ``permute``
    along ``perm`` over ``ranks`` ranks, per message size."""
    transport = LocalMeshTransport(dev)
    rows = []
    for total in total_bytes:
        x = torch.zeros((ranks, total), dtype=torch.uint8, device=dev)
        rows.append((math.log2(total),
                     time_fn(lambda p: transport.permute(p, perm), x, iters=iters)))
        del x
    return rows


def measure_wire_tables(
    axes: Optional[Dict[str, int]] = None,
    total_bytes: Sequence[int] = TOTAL_BYTES,
    iters: int = 5,
    ranks: int = RANKS,
    device="cuda",
) -> Dict[str, List[Tuple[float, float]]]:
    """One-hop wire sweep per mesh axis.

    ``axes`` maps axis name -> size, in order; their product must be
    ``ranks``, which are folded row-major into that mesh.  Each axis is
    timed with a ring along that axis alone (every rank's coordinate on
    the axis shifts by one, the others stay), one local-mesh ``permute``
    of all ``ranks`` rows.  Default: one flat ``wire`` axis over every
    rank (the single-table sweep).  On one card every axis rides the same
    memory, so the tables come out nearly equal.
    """
    dev = resolve_device(device)
    if axes is None:
        axes = {"wire": ranks}
    names = tuple(axes)
    shape = tuple(int(axes[n]) for n in names)
    if math.prod(shape) != ranks:
        raise ValueError(f"mesh {dict(axes)} holds {math.prod(shape)} ranks, not {ranks}")
    coords = list(np.ndindex(*shape))
    rank_of = {c: r for r, c in enumerate(coords)}
    tables: Dict[str, List[Tuple[float, float]]] = {}
    for ai, name in enumerate(names):
        perm = []
        for r, c in enumerate(coords):
            d = list(c)
            d[ai] = (d[ai] + 1) % shape[ai]
            perm.append((r, rank_of[tuple(d)]))
        tables[name] = _time_permutes(perm, total_bytes, iters, ranks, dev)
    return tables


def measure_link_class_tables(
    topology,
    total_bytes: Sequence[int] = TOTAL_BYTES,
    iters: int = 5,
    device="cuda",
) -> Dict[str, List[Tuple[float, float]]]:
    """Per-link-class one-hop wire sweep.

    ``topology`` is a :class:`repro_torch.comm.topology.Topology`; its
    ``nranks`` ranks are the rows of one local-mesh tensor.  Two
    permutations isolate the two tiers of the hierarchy:

    * ``intra``: a ring within each node's rank block (every edge stays
      on one node; a one-rank node sends to itself);
    * ``inter``: rank ``j`` of node ``i`` sends to rank ``j`` of node
      ``i + 1`` (mod nodes; ``j`` wraps within a smaller node): every
      edge crosses nodes.  Measured when it is a permutation.

    Rows are (log2 bytes one rank sends, sec) per class; a single-node
    topology yields ``intra`` only.  On one card both permutations are
    copies within the same memory, so the two tables come out nearly
    equal: this is a smoke path, and a real multi-node machine is what
    would price its slow tier.
    """
    dev = resolve_device(device)
    n = topology.nranks
    by_node: Dict[int, List[int]] = {}
    for r, nd in enumerate(topology.nodes):
        by_node.setdefault(nd, []).append(r)
    intra_perm: List[Tuple[int, int]] = []
    for members in by_node.values():
        k = len(members)
        intra_perm.extend((members[i], members[(i + 1) % k]) for i in range(k))
    perms = {"intra": intra_perm}
    node_ids = sorted(by_node)
    if len(node_ids) > 1:
        inter_perm: List[Tuple[int, int]] = []
        for i, nd in enumerate(node_ids):
            nxt = by_node[node_ids[(i + 1) % len(node_ids)]]
            for j, r in enumerate(by_node[nd]):
                inter_perm.append((r, nxt[j % len(nxt)]))
        if sorted(d for _, d in inter_perm) == list(range(n)):
            perms["inter"] = inter_perm
    return {cls: _time_permutes(perm, total_bytes, iters, n, dev)
            for cls, perm in perms.items()}


def measure_stencil_table(
    radii_set: Sequence[Tuple[int, int, int]] = STENCIL_RADII,
    total_bytes: Sequence[int] = TOTAL_BYTES,
    iters: int = 5,
    ranks: int = RANKS,
    device="cuda",
) -> List[Tuple[float, float, float]]:
    """One weighted box-stencil application over (neighbor count x
    window bytes): rows ``(log2_neighbors, log2_window_bytes, sec)``.

    Times :func:`repro_torch.kernels.ops.stencil_window_update`, the
    primitive every deep-halo application runs, on a float32 cube per
    rank whose window holds about ``total`` bytes, for each op shape in
    ``radii_set``; ``ranks`` ranks a call, as the halo state holds them,
    the row keyed by one rank's window bytes.
    """
    import itertools

    from repro_torch.kernels.ops import stencil_window_update

    dev = resolve_device(device)
    rows: List[Tuple[float, float, float]] = []
    for radii in radii_set:
        rz, ry, rx = radii
        offsets = tuple(
            d
            for d in itertools.product(
                range(-rz, rz + 1), range(-ry, ry + 1), range(-rx, rx + 1)
            )
            if d != (0, 0, 0)
        )
        for total in total_bytes:
            m = max(int(round((total / 4) ** (1.0 / 3.0))), 1)
            shape = (m, m, m)
            arr = torch.zeros(
                (ranks,) + tuple(s + 2 * r for s, r in zip(shape, radii)),
                dtype=torch.float32, device=dev,
            )
            sec = time_fn(
                lambda a: stencil_window_update(a, offsets, 0.4, radii, shape),
                arr, iters=iters,
            )
            rows.append((math.log2(len(offsets)), math.log2(4 * m ** 3), sec))
            del arr
    return rows


def fit_latency_bandwidth(
    rows: Sequence[Tuple[float, float]]
) -> Tuple[Optional[float], Optional[float]]:
    """Least-squares fit of t(n) = latency + n / bandwidth over
    (log2_bytes, sec) rows.  Either term is None when the sweep is too
    small or noisy to resolve it (a non-positive intercept or slope):
    consumers then fall back to the analytic constants, where a clamped
    0.0 would price extra hops as free."""
    if len(rows) < 2:
        return None, None
    nbytes = np.asarray([2.0 ** r[0] for r in rows])
    secs = np.asarray([r[1] for r in rows])
    design = np.stack([np.ones_like(nbytes), nbytes], axis=1)
    (lat, inv_bw), *_ = np.linalg.lstsq(design, secs, rcond=None)
    return (
        float(lat) if lat > 0 else None,
        float(1.0 / inv_bw) if inv_bw > 0 else None,
    )


def calibrate_params(
    name: Optional[str] = None,
    reduced: bool = False,
    strategies=None,
    iters: Optional[int] = None,
    ranks: int = RANKS,
    device="cuda",
    mesh_axes: Optional[Dict[str, int]] = None,
    topology=None,
) -> SystemParams:
    """Full-term calibration: pack + unpack + wire + contiguous copy +
    compress + stencil application, all batched over ``ranks`` local-mesh ranks on
    ``device`` (the card unless ``device="cpu"``).

    ``mesh_axes`` (axis name -> size, product ``ranks``) sweeps the wire
    once per mesh axis into ``wire_tables``/``wire_fits``
    (:func:`measure_wire_tables`); ``topology`` sweeps each link class
    into ``link_tables``/``link_fits``
    (:func:`measure_link_class_tables`).  The flat ring stays the
    axis-agnostic ``wire_table`` either way.

    The base is :data:`~repro_torch.comm.perfmodel.H100_ANALYTIC`, whose
    constants stay as fallbacks for what the tables do not cover.
    ``hbm_bw`` comes from the largest copy, on the tables' scale: one
    rank's bytes read and written over the R-rank launch's time.
    """
    dev = resolve_device(device)
    blocks = REDUCED_BLOCK_BYTES if reduced else BLOCK_BYTES
    totals = REDUCED_TOTAL_BYTES if reduced else TOTAL_BYTES
    radii_set = REDUCED_STENCIL_RADII if reduced else STENCIL_RADII
    # 20 calls a point on the full grid (the reference takes 5): on the
    # card a call is host-bound, and 5 calls scatter by about 30%
    it = iters if iters is not None else (2 if reduced else 20)
    kw = dict(iters=it, ranks=ranks, device=dev)

    pack = measure_pack_table(strategies, blocks, totals, **kw)
    unpack = measure_unpack_table(strategies, blocks, totals, **kw)
    copy = measure_copy_table(totals, **kw)
    compress = measure_compress_table(total_bytes=totals, **kw)
    stencil = measure_stencil_table(radii_set, totals, **kw)
    wire = measure_wire_table(totals, **kw)
    wire_lat, wire_bw = fit_latency_bandwidth(wire)
    wire_tables = wire_fits = None
    if mesh_axes is not None:
        wire_tables = measure_wire_tables(mesh_axes, totals, **kw)
        wire_fits = {ax: fit_latency_bandwidth(rows) for ax, rows in wire_tables.items()}
    link_tables = link_fits = None
    if topology is not None:
        link_tables = measure_link_class_tables(topology, totals, iters=it, device=dev)
        link_fits = {cls: fit_latency_bandwidth(rows) for cls, rows in link_tables.items()}

    hbm_bw = H100_ANALYTIC.hbm_bw
    if copy and copy[-1][1] > 0:
        hbm_bw = 2.0 * (2.0 ** copy[-1][0]) / copy[-1][1]
    return dataclasses.replace(
        H100_ANALYTIC,
        name=name or f"{dev.type}_calibrated",
        hbm_bw=hbm_bw,
        pack_table={k: tuple(v) for k, v in pack.items() if v},
        unpack_table={k: tuple(v) for k, v in unpack.items() if v},
        compress_table={k: tuple(v) for k, v in compress.items() if v},
        wire_table=tuple(wire),
        copy_table=tuple(copy),
        stencil_table=tuple(stencil),
        wire_tables=wire_tables,
        wire_fits=wire_fits,
        link_tables=link_tables,
        link_fits=link_fits,
        wire_latency=wire_lat,
        wire_bw=wire_bw,
        link_bw=wire_bw if wire_bw else H100_ANALYTIC.link_bw,
        link_latency=wire_lat if wire_lat else H100_ANALYTIC.link_latency,
    )
