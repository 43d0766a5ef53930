"""Per-device cost of one step from a walk of its operators (the
counterpart of the reference's ``repro.roofline.hlo_cost``).

The reference compiles a step and parses the partitioned HLO text; its
parser must recover loop trip counts, because XLA counts a ``while``
body once.  The port runs eagerly: :func:`walk_cost` calls the step once
under a :class:`~torch.utils._python_dispatch.TorchDispatchMode` and
counts every operator that runs, each time it runs, so a Python loop
over layers or chunks is counted whole.  The inputs are meta tensors,
or DTensors over meta tensors on a mesh of a fake process group, so the
walk touches no device and allocates nothing.

What one device does:

* An operator with a DTensor among its arguments is not counted: the
  mode returns ``NotImplemented`` and DTensor then issues the plain-tensor
  operators of each rank's blocks, which are counted at their local
  shapes, collectives included.  DTensor's sharding propagation runs each
  operator it has not met before at the global shape under its own
  ``FakeTensorMode``; those calls are told apart by that mode being
  active (never true of the step's own operators), not by the
  propagation cache's state, so two walks of one step count alike.
* FLOPs: ``torch.utils.flop_counter``'s formulas for the products,
  convolutions and attention it registers; one per output element for
  every other operator that computes (``hlo_cost``'s rule for the ops
  XLA leaves outside a dot).
* Bytes: the inputs plus the outputs of every operator that computes.
  The eager port fuses nothing, so each operator does read and write
  HBM.  A view costs nothing and an operator on a view counts the view's
  bytes, not its base's; a write into a slice (``copy_``, ``fill_``,
  ``zero_``) counts the slice read from its source and written, twice the
  slice, as ``hlo_cost`` counts a dynamic-update-slice.
* Collectives by kind (``all-gather``, ``reduce-scatter``, ``all-reduce``,
  ``all-to-all``, ``collective-permute``), from the ``_c10d_functional``
  operators, as the bytes of their results at the local shape; they add
  to the bytes too, as in ``hlo_cost``.
* Memory: the argument and output bytes a device holds (each storage
  once), and ``temp_size_in_bytes``, the peak of the bytes held by
  storages created during the walk while they are alive.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["COLLECTIVE_KINDS", "OpCost", "walk_cost"]

#: the collective kinds, as ``hlo_cost`` names them
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                    "collective-permute")

#: ``_c10d_functional`` operator name fragment -> collective kind
_C10D_KINDS = (("all_gather", "all-gather"), ("reduce_scatter", "reduce-scatter"),
               ("all_reduce", "all-reduce"), ("all_to_all", "all-to-all"),
               ("broadcast", "collective-permute"), ("send", "collective-permute"),
               ("recv", "collective-permute"), ("permute", "collective-permute"))

_aten = torch.ops.aten
#: operators that move no bytes: allocation, aliasing, host reads
_FREE = frozenset((
    _aten.empty.memory_format, _aten.empty_strided.default, _aten.empty_like.default,
    _aten._unsafe_view.default, _aten.lift_fresh.default, _aten._local_scalar_dense.default,
    _aten.set_.source_Storage_storage_offset, _aten.resize_.default,
))
#: operators that overwrite their first argument without reading it
_WRITE_ONLY = frozenset((_aten.copy_.default, _aten.fill_.Scalar, _aten.fill_.Tensor,
                         _aten.zero_.default))


@dataclass
class OpCost:
    """The walk's counts for one device: ``HloCost``'s fields, and the
    memory that ``compiled.memory_analysis()`` gives the reference."""

    flops: float = 0.0
    bytes: float = 0.0
    coll: Dict[str, float] = field(default_factory=dict)
    by_op: Dict[str, float] = field(default_factory=dict)        # op -> bytes
    coll_shapes: Dict[str, float] = field(default_factory=dict)  # "kind dtype[shape]" -> bytes
    argument_size_in_bytes: int = 0
    output_size_in_bytes: int = 0
    temp_size_in_bytes: int = 0
    ops: Optional[List[str]] = None   # one line per counted op (``record=True``)

    @property
    def coll_bytes(self) -> float:
        return sum(self.coll.values())

    def top_ops(self, n: int = 8):
        return sorted(self.by_op.items(), key=lambda kv: -kv[1])[:n]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(t):
    """A DTensor's local block; any other tensor as it is."""
    return getattr(t, "_local_tensor", t)


def _tensors(tree, out=None) -> List[torch.Tensor]:
    """The tensors (local blocks) among ``tree``'s lists, tuples and
    dicts, in order (an operator's arguments and results: no pytree
    machinery on the walk's hot path)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(_local(tree))
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _storage_bytes(tree) -> Tuple[int, set]:
    """The bytes of the distinct storages under ``tree`` (local blocks),
    and their keys."""
    seen, total = set(), 0
    for t in _tensors(tree):
        s = t.untyped_storage()
        if id(s) not in seen:
            seen.add(id(s))
            total += s.nbytes()
    return total, seen


def _shape(t: torch.Tensor) -> str:
    return f"{str(t.dtype).replace('torch.', '')}[{','.join(map(str, t.shape))}]"


def _collective_kind(func) -> Optional[str]:
    """The kind of a ``_c10d_functional`` collective, "" for its other
    operators, None outside it."""
    if func.namespace != "_c10d_functional":
        return None
    name = func._opname
    for frag, kind in _C10D_KINDS:
        if frag in name:
            return kind
    return ""  # ``wait_tensor``, ``_wrap_tensor_autograd``: no traffic of their own


class _Walk(TorchDispatchMode):
    def __init__(self, cost: OpCost, known: set):
        super().__init__()
        self.cost = cost
        self.known = known             # argument storages: not temporaries
        self.live: Dict[int, int] = {}  # id(storage) -> bytes, created in the walk
        self.held = 0

    def _free(self, key: int) -> None:
        self.held -= self.live.pop(key, 0)

    def _track(self, outs, ins) -> None:
        inputs = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            s = t.untyped_storage()
            key = id(s)
            if key in self.live or key in self.known or key in inputs:
                continue
            self.live[key] = s.nbytes()
            self.held += s.nbytes()
            weakref.finalize(s, self._free, key)
        self.cost.temp_size_in_bytes = max(self.cost.temp_size_in_bytes, self.held)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, _dtensor()) for t in types):
            return NotImplemented  # DTensor issues each rank's plain-tensor ops
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None:
            return out  # DTensor's sharding propagation, at the global shape
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        self._track(outs, ins)
        info = _INFO.get(func) or _INFO.setdefault(func, _op_info(func))
        name, kind, formula, write_only = info
        if name is None:
            return out
        cost = self.cost
        out_b = sum(_nbytes(t) for t in outs)
        if kind:
            cost.coll[kind] = cost.coll.get(kind, 0.0) + out_b
            cost.bytes += out_b
            cost.by_op[kind] = cost.by_op.get(kind, 0.0) + out_b
            key = f"{kind} {_shape(outs[0])}"
            cost.coll_shapes[key] = cost.coll_shapes.get(key, 0.0) + out_b
            flops, nbytes = 0, out_b
        else:
            nbytes = sum(_nbytes(t) for t in (ins[1:] if write_only else ins)) + out_b
            flops = (formula(*args, **kwargs, out_val=out) if formula is not None
                     else sum(t.numel() for t in outs))
            cost.flops += flops
            cost.bytes += nbytes
            cost.by_op[name] = cost.by_op.get(name, 0.0) + nbytes
        if cost.ops is not None:
            cost.ops.append(f"{name} {' '.join(_shape(t) for t in ins)} -> "
                            f"{' '.join(_shape(t) for t in outs)} bytes={nbytes} flops={flops}")
        return out


#: per operator: (name, collective kind or "", FLOP formula, overwrites
#: its first argument); name None for an operator that moves no bytes
_INFO: Dict[object, tuple] = {}


def _op_info(func) -> tuple:
    from torch.utils.flop_counter import flop_registry

    kind = _collective_kind(func)
    if kind == "" or func.is_view or func in _FREE:
        return None, "", None, False
    if kind:
        return kind, kind, None, False
    name = func._overloadpacket.__name__ if func.namespace == "aten" else str(func)
    return name, "", flop_registry.get(func._overloadpacket), func in _WRITE_ONLY


def _dtensor():
    from torch.distributed.tensor import DTensor

    return DTensor


def walk_cost(fn, *args, record: bool = False, **kwargs) -> Tuple[object, OpCost]:
    """Run ``fn(*args, **kwargs)`` once under the counting mode.  Returns
    ``(result, OpCost)``: the counts are one device's (see the module
    docstring); ``record`` keeps one line per counted op in ``ops``."""
    cost = OpCost(ops=[] if record else None)
    cost.argument_size_in_bytes, known = _storage_bytes((args, kwargs))
    walk = _Walk(cost, known)
    with walk:
        result = fn(*args, **kwargs)
    cost.output_size_in_bytes = _storage_bytes(result)[0]
    return result, cost
