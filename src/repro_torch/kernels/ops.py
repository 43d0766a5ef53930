"""Public pack/unpack operations with plan caching, and the stencil
window primitives.

This is TEMPI's ``MPI_Pack``/``MPI_Unpack`` (paper §6.2) for torch
tensors.  The committed type's canonical StridedBlock drives everything:

    kind CONTIG       -> one contiguous copy (cudaMemcpyAsync analogue)
    kind KERNEL_2D/3D -> a CUDA kernel, chosen by the strategy plugin
    kind KERNEL_ND    -> the gather path (as in the reference)
    unplannable geometry -> the gather path

``incount`` repeats the datatype at ``extent`` strides, handled as an
extra outer dimension exactly as the paper describes (§3.3 last ¶).

Strategy *dispatch* lives in ``repro_torch.comm.api`` (the strategy
registry); this module owns the strategy-independent machinery.
``strategy`` arguments accept a Strategy object, a registered name, or
None (the static-auto heuristic).

Buffers of any dtype/shape are re-viewed as bytes without copying, so
they must be contiguous.  With ``batched=True`` the leading dimension is
a batch (the local mesh's ranks) and the datatype applies to each
``buf[b]``: one kernel launch serves the whole batch.  :func:`unpack`
writes **in place** into its buffer and returns it.
"""

from __future__ import annotations

import functools
import itertools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.commit import CommittedType, KernelKind
from repro_torch.core.strided_block import StridedBlock
from repro_torch.kernels.build import library
from repro_torch.kernels.geometry import PackGeometry, plan_geometry
from repro_torch.kernels.pack import aligned

__all__ = [
    "byte_view",
    "unbyte_view",
    "as_words",
    "batch_bytes",
    "pack",
    "unpack",
    "pack_block",
    "run_pack_kernel",
    "run_unpack_kernel",
    "shifted_window_sum",
    "stencil_window_plain",
    "stencil_window_update",
    "stencil_window_pair",
    "stencil_window_chain",
]

_WORD_DTYPE = {1: torch.uint8, 2: torch.int16, 4: torch.int32}

#: geometry plan cache — the paper's §4 "caching layer": keyed by the
#: committed type's content fingerprint + incount, so repeated
#: Pack/Unpack of the same structure re-dispatch in a dict lookup.
_PLAN_CACHE: Dict[Tuple[str, int], "_Plan"] = {}


def _resolve(strategy):
    from repro_torch.comm.api import resolve_strategy

    return resolve_strategy(strategy)


# ---------------------------------------------------------------------------
# shifted-window stencil primitives (per-dimension radii)
# ---------------------------------------------------------------------------
#
# Every stencil of the halo layer is one operation: accumulate windows
# of an N-D array shifted by a set of offsets, over a window whose
# origin/shape the caller picks.  The window is taken over the LAST
# three dimensions, so any leading dimensions (the local mesh's ranks)
# are updated in the same call.  One primitive means one accumulation
# order, which is what keeps overlapping results bit-identical.  On the
# card the update is one hand-written kernel (``csrc/stencil.cu``) that
# reads each input cell once; on the CPU it is the plain torch version
# (:func:`stencil_window_plain`), cell for cell the same arithmetic.

def _window(arr: torch.Tensor, origin, shape) -> torch.Tensor:
    (z, y, x), (nz, ny, nx) = origin, shape
    return arr[..., z : z + nz, y : y + ny, x : x + nx]


def shifted_window_sum(arr, offsets, origin, shape):
    """Sum of ``arr`` windows at ``origin + d`` for each offset ``d``.

    Offsets may be negative; the caller guarantees every shifted window
    stays in bounds.  Accumulation is in ``offsets`` order, so two calls
    with the same offsets and values produce bit-identical results.
    """
    acc = torch.zeros(arr.shape[:-3] + tuple(shape), dtype=arr.dtype, device=arr.device)
    for d in offsets:
        acc += _window(arr, tuple(o + di for o, di in zip(origin, d)), shape)
    return acc


def stencil_window_plain(arr, offsets, weight, origin, shape):
    """The plain torch version of :func:`stencil_window_update` (any
    device): a new tensor holding the updated window.  The scalar factors
    are rounded to ``arr.dtype`` first, as in the reference.  They stay
    on the host, 0-dim: a copy of a host scalar to the card would
    synchronize the stream each call."""
    w = torch.tensor(weight, dtype=arr.dtype)
    acc = shifted_window_sum(arr, offsets, origin, shape)
    center = _window(arr, origin, shape)
    return acc.mul_(w / len(offsets)).add_(center * (1 - w))


@functools.lru_cache(maxsize=64)
def _box_offsets(radii):
    """The offsets of the full ``radii`` box minus its centre, in
    ``itertools.product`` order (:attr:`repro_torch.halo.StencilOp.offsets`)."""
    return tuple(d for d in itertools.product(*(range(-r, r + 1) for r in radii))
                 if d != (0, 0, 0))


@functools.lru_cache(maxsize=64)
def _factors(weight, n, dtype):
    """``(w / n, 1 - w)`` rounded to ``dtype`` exactly as
    :func:`stencil_window_plain` rounds them, as Python floats."""
    w = torch.tensor(weight, dtype=dtype)
    return (w / n).item(), (1 - w).item()


def _batched(t: torch.Tensor, name: str) -> torch.Tensor:
    """``t`` as a ``(B, z, y, x)`` view, x contiguous; raises if the
    leading dimensions do not fold into one stride."""
    if t.stride(-1) != 1 and t.shape[-1] > 1:
        raise ValueError(f"{name} must be contiguous along its last dimension")
    return t.unsqueeze(0) if t.dim() == 3 else t.view((-1,) + tuple(t.shape[-3:]))


def _span(t: torch.Tensor):
    """The byte interval ``[lo, hi)`` that a tensor's elements lie in."""
    last = sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
    lo = t.data_ptr()
    return lo, lo + (last + 1) * t.element_size()


def _window_out(arr: torch.Tensor, origin, shape) -> torch.Tensor:
    """A new tensor for the window, its rows on the same 16-byte phase as
    the window's rows in ``arr`` (a view into rows padded to 16 bytes), so
    the kernel moves 16 bytes a thread on both sides."""
    es = arr.element_size()
    first = arr.data_ptr() + es * sum(o * s for o, s in zip(origin, arr.stride()[-3:]))
    phase = first % 16 // es
    lanes = 16 // es
    pitch = -(-(phase + shape[2]) // lanes) * lanes
    buf = torch.empty(tuple(arr.shape[:-3]) + (shape[0], shape[1], pitch), dtype=arr.dtype,
                      device=arr.device)
    return buf[..., phase : phase + shape[2]]


def stencil_window_update(arr, offsets, weight, origin, shape, out=None, copy_rim=False):
    """One weighted-neighborhood stencil update of the window
    ``arr[..., origin : origin + shape]``:

        new = (1 - w) * center + (w / len(offsets)) * sum(shifted views)

    Writes the updated window into ``out`` (a tensor of the window's
    shape, leading dimensions included, that does not overlap the cells
    the update reads) or, when None, into a new tensor; returns it.  The
    caller splices it back.  With ``copy_rim`` the destination is the
    window grown by the offsets' radii on every side, the cells the update
    reads, and its outer layer receives those cells of ``arr`` unchanged.

    A CUDA tensor takes the kernel ``csrc/stencil.cu``: float32 or
    float64, the offsets of a full box minus its centre in
    ``itertools.product`` order (every :class:`repro_torch.halo.StencilOp`),
    anything else raises.  A CPU tensor takes :func:`stencil_window_plain`.
    Both give the same bits.  Launches are counted in ``.launches``, and
    those that took the runtime-radii kernel, not the fast path for radii
    (1, 1, 1), in ``.runtime_launches`` too.
    """
    offsets = tuple(tuple(int(c) for c in d) for d in offsets)
    radii = tuple(max(abs(d[a]) for d in offsets) for a in range(3)) if offsets else (0, 0, 0)
    origin, shape = tuple(origin), tuple(shape)
    read = (tuple(o - r for o, r in zip(origin, radii)),
            tuple(n + 2 * r for n, r in zip(shape, radii)))
    region = read if copy_rim else (origin, shape)
    if arr.device.type == "cpu":
        new = stencil_window_plain(arr, offsets, weight, origin, shape)
        if not copy_rim:
            return new if out is None else out.copy_(new)
        if out is None:
            out = torch.empty(tuple(arr.shape[:-3]) + region[1], dtype=arr.dtype)
        out.copy_(_window(arr, *region))
        _window(out, radii, shape).copy_(new)
        return out
    if not offsets or offsets != _box_offsets(radii):
        raise ValueError("the stencil kernel takes the offsets of a full box minus its "
                         f"centre, in itertools.product order; got {offsets}")
    out = _kernel_out(arr, read, region, out, f"window {origin} + {shape} with radii {radii}")
    if min(shape) == 0 or out.numel() == 0:
        return out
    src, dst = _batched(arr, "arr"), _batched(out, "out")
    scale, keep = _factors(float(weight), len(offsets), arr.dtype)
    fn = library("stencil").tempi_stencil_update
    err = fn(_first(arr, src, region[0]), *src.stride()[:3], dst.data_ptr(), *dst.stride()[:3],
             src.shape[0], *region[1], *radii, int(copy_rim), arr.element_size(), scale, keep,
             arr.device.index, torch.cuda.current_stream(arr.device).cuda_stream)
    if err != 0:
        if err != _RAN_RUNTIME:
            raise RuntimeError(f"tempi_stencil_update launch failed with CUDA error {err}")
        stencil_window_update.runtime_launches += 1
    stencil_window_update.launches += 1
    return out


def _kernel_out(arr, read, region, out, what):
    """Check a stencil kernel's operands on the card: ``arr`` float32 or
    float64, the cells ``read`` inside it, ``out`` (a new tensor when
    None) shaped as ``region`` and clear of the cells read.  Returns out."""
    if arr.device.type != "cuda":
        raise ValueError(f"unsupported device {arr.device}")
    if arr.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the stencil kernel takes float32 or float64, not {arr.dtype}")
    dims = tuple(arr.shape[-3:])
    if any(o < 0 or o + n > d for o, n, d in zip(*read, dims)):
        raise ValueError(f"{what} leaves {dims}")
    if out is None:
        out = _window_out(arr, *region)
    if (out.shape != arr.shape[:-3] + region[1] or out.dtype != arr.dtype
            or out.device != arr.device):
        raise ValueError(f"out is {out.dtype} {tuple(out.shape)} on {out.device}; need "
                         f"{arr.dtype} {tuple(arr.shape[:-3] + region[1])} on {arr.device}")
    (rlo, rhi), (wlo, whi) = _span(_window(arr, *read)), _span(out)
    if rlo < whi and wlo < rhi and out.numel() and \
            arr.untyped_storage().data_ptr() == out.untyped_storage().data_ptr():
        raise ValueError("out overlaps the cells the update reads")
    return out


def _first(arr, src, origin) -> int:
    """The address of ``arr``'s cell at ``origin`` (last three dimensions)
    in its first buffer; ``src`` is arr as :func:`_batched` views it."""
    return arr.data_ptr() + arr.element_size() * sum(
        o * s for o, s in zip(origin, src.stride()[1:]))


#: ``tempi_stencil_update``'s answer when the runtime-radii kernel ran
_RAN_RUNTIME = -2

#: kernel launches of :func:`stencil_window_update`, and of them those
#: that took the runtime-radii kernel
stencil_window_update.launches = 0
stencil_window_update.runtime_launches = 0


def stencil_window_pair(arr, offsets, weights, origin, shape, out=None):
    """Two consecutive radius-(1, 1, 1) updates in one pass: the first
    (weight ``weights[0]``) over the window ``arr[..., origin : origin +
    shape]``, the second (``weights[1]``) over the first's result there,
    in the window shrunk by one cell per side.

    Writes the window grown by one cell per side, the cells the first
    update reads, into ``out`` (a tensor of that shape, leading dimensions
    included, clear of ``arr``'s cells; a new one when None) and returns
    it: the outer layer holds ``arr``'s cells unchanged, the next layer
    the first update, the rest the second.  That is what
    ``stencil_window_update(..., copy_rim=True)`` followed by the second
    update in place leaves.  ``offsets`` are the radius-(1, 1, 1) box's,
    as :func:`stencil_window_update` takes them.

    A CUDA tensor takes the fused kernel (``tempi_stencil_pair`` in
    ``csrc/stencil.cu``), float32 or float64, which keeps the first
    update's values on the chip; anything else raises.  A CPU tensor
    takes the two plain updates in turn.  Both give the same bits.
    Launches are counted in ``.launches``."""
    offsets = tuple(tuple(int(c) for c in d) for d in offsets)
    if offsets != _box_offsets((1, 1, 1)):
        raise ValueError("the fused pair takes the radius-(1, 1, 1) box minus its centre, "
                         f"in itertools.product order; got {offsets}")
    w1, w2 = (float(w) for w in weights)
    origin, shape = tuple(origin), tuple(shape)
    inner = tuple(n - 2 for n in shape)
    if min(inner) < 1:
        raise ValueError(f"window {shape} leaves the second update no cell")
    grown = (tuple(o - 1 for o in origin), tuple(n + 2 for n in shape))
    if arr.device.type == "cpu":
        out = stencil_window_update(arr, offsets, w1, origin, shape, out=out, copy_rim=True)
        _window(out, (2, 2, 2), inner).copy_(
            stencil_window_update(out, offsets, w2, (2, 2, 2), inner))
        return out
    out = _kernel_out(arr, grown, grown, out, f"window {origin} + {shape}, grown by one,")
    src, dst = _batched(arr, "arr"), _batched(out, "out")
    (s1, k1), (s2, k2) = (_factors(w, len(offsets), arr.dtype) for w in (w1, w2))
    err = library("stencil").tempi_stencil_pair(
        _first(arr, src, grown[0]), *src.stride()[:3], dst.data_ptr(), *dst.stride()[:3],
        src.shape[0], *grown[1], arr.element_size(), s1, k1, s2, k2, arr.device.index,
        torch.cuda.current_stream(arr.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tempi_stencil_pair launch failed with CUDA error {err}")
    stencil_window_pair.launches += 1
    return out


#: fused-pair launches of :func:`stencil_window_pair`
stencil_window_pair.launches = 0


def stencil_window_chain(arr, stages):
    """Apply a *sequence* of stencil window updates, each stage consuming
    the previous stage's window: stage ``(offsets, weight, radii)``
    shrinks the current window by ``radii`` per side.  Returns every
    intermediate block."""
    blocks = []
    x = arr
    for k, (offsets, weight, radii) in enumerate(stages):
        shape = tuple(s - 2 * r for s, r in zip(x.shape[-3:], radii))
        if any(s < 1 for s in shape):
            raise ValueError(
                f"window {tuple(arr.shape[-3:])} too small for stage {k + 1} "
                f"of the chain (radii {tuple(radii)})"
            )
        x = stencil_window_update(x, offsets, weight, tuple(radii), shape)
        blocks.append(x)
    return blocks


# ---------------------------------------------------------------------------
# byte / word re-viewing (zero-copy)
# ---------------------------------------------------------------------------

def byte_view(arr: torch.Tensor) -> torch.Tensor:
    """Flat uint8 view of a contiguous tensor's bytes (no copy)."""
    if arr.dtype == torch.bool:
        raise TypeError("bool buffers are not byte-addressable; cast first")
    if not arr.is_contiguous():
        raise ValueError("byte views need a contiguous tensor")
    return arr.reshape(-1).view(torch.uint8)


def unbyte_view(b: torch.Tensor, dtype, shape) -> torch.Tensor:
    """Inverse of :func:`byte_view`."""
    return b.view(dtype).reshape(shape)


def as_words(b: torch.Tensor, w: int) -> torch.Tensor:
    """uint8[n] -> W-byte words [n/w] (a view; n a multiple of w)."""
    return b.view(_WORD_DTYPE[w])


def batch_bytes(buf: torch.Tensor, batched: bool) -> torch.Tensor:
    """``(B, n)`` uint8 view of ``buf``: the whole buffer as one row, or
    one row per leading index when ``batched``."""
    b = byte_view(buf)
    return b.view(buf.shape[0], -1) if batched else b.view(1, -1)


def _rows_out(out: torch.Tensor, batch: int, nbytes: int) -> torch.Tensor:
    """``out`` (a (B, nbytes) or, unbatched, (nbytes,) uint8 tensor) as
    the 2D view the leaf kernels write."""
    if out.dtype != torch.uint8:
        out = byte_view(out)
    if out.dim() == 1:
        out = out.view(batch, -1) if batch > 1 else out.unsqueeze(0)
    if tuple(out.shape) != (batch, nbytes):
        raise ValueError(f"out has shape {tuple(out.shape)}; need {(batch, nbytes)}")
    return out


def _packed_rows(packed: torch.Tensor, batch: int) -> torch.Tensor:
    if packed.dtype != torch.uint8:
        packed = byte_view(packed)
    if packed.dim() == 1:
        return packed.view(batch, -1) if batch > 1 else packed.unsqueeze(0)
    return packed


# ---------------------------------------------------------------------------
# planning
# ---------------------------------------------------------------------------

class _Plan:
    """Host-side execution plan for one (committed type, incount)."""

    __slots__ = ("sb", "reps", "rep_extent", "geom", "kind")

    def __init__(self, ct: CommittedType, incount: int):
        sb = ct.block
        self.kind = ct.kernel
        self.reps = 1
        self.rep_extent = ct.extent
        if sb is not None and incount > 1:
            if sb.ndims == 1:
                if ct.extent == sb.counts[0] and sb.start == 0:
                    # contiguous repetitions stay contiguous
                    sb = StridedBlock(0, (sb.counts[0] * incount,), (1,))
                else:
                    sb = StridedBlock(
                        sb.start, (sb.counts[0], incount), (1, ct.extent)
                    )
            elif sb.ndims == 2:
                sb = StridedBlock(
                    sb.start, sb.counts + (incount,), sb.strides + (ct.extent,)
                )
            else:
                # 3D+ repeated: loop reps on the host (paper: "handled
                # dynamically" — known only at the call site)
                self.reps = incount
        self.sb = sb
        self.geom = (
            plan_geometry(sb) if sb is not None and sb.ndims in (2, 3) else None
        )


def _plan(ct: CommittedType, incount: int) -> _Plan:
    # content-fingerprint key: equal structures share a plan, and a
    # recycled id() can never serve a stale one
    key = (ct.fingerprint, incount)
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        plan = _Plan(ct, incount)
        _PLAN_CACHE[key] = plan
    return plan


# ---------------------------------------------------------------------------
# driving the strategy kernels
# ---------------------------------------------------------------------------

def _fit(geom: PackGeometry, sb: StridedBlock, *tensors) -> PackGeometry:
    """The geometry to launch with: ``geom``, or its one-byte-word form
    when an operand's pointer or batch stride is not W-aligned (e.g. a
    segment at an odd wire offset).  Same bytes, no copy."""
    if all(aligned(t, geom.word_bytes) for t in tensors):
        return geom
    return plan_geometry(sb, word_bytes=1)


def run_pack_kernel(b, sb, geom, kernel, out):
    """Drive a ``(src, geom, out)`` pack kernel on ``(B, n)`` bytes."""
    return kernel(b, _fit(geom, sb, b, out), out)


def run_unpack_kernel(b, packed, sb, geom, kernel):
    """Drive a ``(dst, packed, geom)`` in-place unpack kernel."""
    return kernel(b, packed, _fit(geom, sb, b, packed))


# ---------------------------------------------------------------------------
# pack / unpack
# ---------------------------------------------------------------------------

def _shifted(plan: _Plan, base: int) -> Tuple[StridedBlock, Optional[PackGeometry]]:
    if not base:
        return plan.sb, plan.geom
    sb = StridedBlock(plan.sb.start + base, plan.sb.counts, plan.sb.strides)
    return sb, (plan_geometry(sb) if sb.ndims in (2, 3) else None)


def _pack_one(b, plan: _Plan, strat, base: int, out) -> None:
    """Pack one repetition (byte offsets shifted by ``base``) into out."""
    sb, geom = _shifted(plan, base)
    if sb.ndims == 1:
        out.copy_(b[:, sb.start : sb.start + sb.counts[0]])
    else:
        strat.pack_leaf(b, sb, geom, out)


def _check_strided(ct: CommittedType, plan: _Plan) -> None:
    if plan.kind is KernelKind.GENERIC or plan.sb is None:
        raise TypeError(f"{ct.datatype!r} is not a strided type")


def pack(
    buf: torch.Tensor,
    ct: CommittedType,
    incount: int = 1,
    strategy=None,
    *,
    out: Optional[torch.Tensor] = None,
    batched: bool = False,
) -> torch.Tensor:
    """MPI_Pack: gather the non-contiguous bytes ``ct`` describes from
    ``buf`` into a contiguous uint8 buffer of ``ct.size * incount``
    bytes (``(B, ct.size * incount)`` when ``batched``).  Writes into
    ``out`` when given and returns it."""
    strat = _resolve(strategy)
    plan = _plan(ct, incount)
    _check_strided(ct, plan)
    b = batch_bytes(buf, batched)
    nbytes = ct.size * incount
    if out is None:
        out = torch.empty((b.shape[0], nbytes) if batched else (nbytes,),
                          dtype=torch.uint8, device=buf.device)
    o = _rows_out(out, b.shape[0], nbytes)
    step = plan.sb.size
    for rep in range(plan.reps):
        _pack_one(b, plan, strat, rep * plan.rep_extent,
                  o[:, rep * step : (rep + 1) * step])
    return out


def pack_block(
    buf: torch.Tensor,
    sb: StridedBlock,
    strategy=None,
    *,
    out: Optional[torch.Tensor] = None,
    batched: bool = False,
) -> torch.Tensor:
    """Low-level pack straight from a StridedBlock (no committed type).

    Used by the comm layer for derived blocks (e.g. extracting member
    bytes out of a received bounding window).  ``buf`` may also be a
    ``(B, n)`` uint8 tensor with ``batched=True`` whose rows are
    contiguous but not each other's neighbours (a wire slice)."""
    strat = _resolve(strategy)
    if batched and buf.dtype == torch.uint8 and buf.dim() == 2:
        b = buf
    else:
        b = batch_bytes(buf, batched)
    if out is None:
        out = torch.empty((b.shape[0], sb.size) if batched else (sb.size,),
                          dtype=torch.uint8, device=buf.device)
    o = _rows_out(out, b.shape[0], sb.size)
    if sb.ndims == 1:
        o.copy_(b[:, sb.start : sb.start + sb.counts[0]])
    else:
        strat.pack_leaf(b, sb, plan_geometry(sb) if sb.ndims in (2, 3) else None, o)
    return out


def _unpack_one(b, packed, plan: _Plan, strat, base: int) -> None:
    sb, geom = _shifted(plan, base)
    if sb.ndims == 1:
        b[:, sb.start : sb.start + sb.counts[0]].copy_(packed)
    else:
        strat.unpack_leaf(b, packed, sb, geom)


def unpack(
    buf: torch.Tensor,
    packed: torch.Tensor,
    ct: CommittedType,
    incount: int = 1,
    strategy=None,
    *,
    batched: bool = False,
) -> torch.Tensor:
    """MPI_Unpack: scatter ``packed`` (uint8, ``size*incount`` bytes —
    per batch row when ``batched``) into ``buf`` per the committed
    datatype.  Writes **in place** into ``buf`` and returns it."""
    strat = _resolve(strategy)
    plan = _plan(ct, incount)
    _check_strided(ct, plan)
    b = batch_bytes(buf, batched)
    pk = _packed_rows(packed, b.shape[0])
    step = plan.sb.size
    for rep in range(plan.reps):
        _unpack_one(b, pk[:, rep * step : (rep + 1) * step], plan, strat,
                    rep * plan.rep_extent)
    return buf
