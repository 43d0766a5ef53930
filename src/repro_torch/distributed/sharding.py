"""Logical-axis sharding rules for a device mesh (the port of the
reference's ``repro.distributed.sharding``).

Model code never names physical mesh axes: it annotates activations with
*logical* axes through :func:`constrain`, and parameters are placed by
:func:`param_partition_spec`.  The launcher installs a rule set mapping
logical to physical axes for the current mesh (:func:`use_rules`); axes
absent from the mesh are dropped, so the same model code runs on the
16x16 production mesh, the 2x16x16 multi-pod mesh, a (2, 2) test mesh
and one card with no mesh at all.

The rules and their resolution are the reference's, transcribed.  A
spec is a :class:`PartitionSpec`, a tuple holding what the reference's
``jax.sharding.PartitionSpec`` holds (per tensor dim: ``None``, an axis
name or a tuple of names).  The torch half is new: a mesh is a
:class:`torch.distributed.device_mesh.DeviceMesh` with named dims,
:func:`placements` turns a spec into DTensor placements, and
:func:`param_placements` maps the port's per-layer parameters onto the
reference's stacked paths.  :func:`resolve` reads only a mesh's axis
names and sizes, so a stand-in with ``axis_names`` and a ``shape``
mapping plans without any process group.

With no mesh active :func:`constrain` and :func:`replicated` return
their argument after one attribute read: the single-card paths pay
nothing for the annotations.
"""

from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch

__all__ = [
    "DEFAULT_RULES",
    "PartitionSpec",
    "Sharding",
    "ShardingRules",
    "active",
    "bind_rules",
    "constrain",
    "distribute",
    "embedding_lookup",
    "full_tensor",
    "local_call",
    "local_offset",
    "logical_spec",
    "mesh_axes",
    "param_logical_axes",
    "param_partition_spec",
    "param_placements",
    "param_specs",
    "placements",
    "replicate_on",
    "replicated",
    "shard_call",
    "shard_model",
    "take_last",
    "tree_partition_specs",
    "tree_paths",
    "unshard_seq",
    "use_rules",
]

Physical = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """Per tensor dim, the mesh axes it is sharded over: ``None``
    (replicated), one axis name or a tuple of names.
    ``tuple(PartitionSpec(...))`` equals ``tuple`` of the reference's
    ``jax.sharding.PartitionSpec`` with the same entries."""

    def __new__(cls, *entries: Physical) -> "PartitionSpec":
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def mesh_axes(mesh) -> Tuple[Tuple[str, ...], Dict[str, int]]:
    """``(axis names, {name: size})`` of a ``DeviceMesh`` (its
    ``mesh_dim_names``) or of a stand-in with ``axis_names`` and a
    ``shape`` mapping, as the reference's fake meshes have."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return tuple(names), {n: mesh.size(i) for i, n in enumerate(names)}
    return tuple(mesh.axis_names), {n: mesh.shape[n] for n in mesh.axis_names}


@dataclass(frozen=True)
class ShardingRules:
    """Mapping of logical axis names to physical mesh axes."""

    batch: Physical = ("pod", "data")
    seq: Physical = "model"          # activation sequence sharding (SP)
    kv_seq: Physical = "model"       # KV-cache sequence sharding
    heads: Physical = "model"        # attention heads / tp
    d_ff: Physical = "model"         # MLP hidden
    vocab: Physical = "model"        # embedding/logits vocab dim
    d_model: Physical = None         # hidden size (kept replicated)
    fsdp: Physical = None            # weight d_model dim (ZeRO-3 style)
    expert: Physical = None          # MoE expert dim
    moe_groups: Physical = ("pod", "data", "model")  # grouped-dispatch dim
    moe_groups_ff: Physical = ("pod", "data")  # groups dim inside expert FFN
    state: Physical = "model"        # SSM / linear-attn state heads

    def resolve(self, logical: Optional[str], mesh, dim: Optional[int] = None) -> Physical:
        """Logical -> physical axes; axes absent from the mesh are
        dropped, and (when ``dim`` is given) trailing axes are dropped
        until the axis-size product divides the dimension, so a batch of
        1 or 2 KV heads falls back to replication instead of padding."""
        if logical is None:
            return None
        phys = getattr(self, logical)
        if phys is None:
            return None
        if isinstance(phys, str):
            phys = (phys,)
        names, sizes = mesh_axes(mesh)
        avail = [a for a in phys if a in names]
        if dim is not None:
            while avail and dim % math.prod(sizes[a] for a in avail):
                avail.pop()
        if not avail:
            return None
        return tuple(avail) if len(avail) > 1 else avail[0]


DEFAULT_RULES = ShardingRules()


class _Active(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: ShardingRules = DEFAULT_RULES


_ACTIVE = _Active()


@contextlib.contextmanager
def use_rules(mesh, rules: ShardingRules = DEFAULT_RULES):
    """Install ``(mesh, rules)`` for the model code's annotations
    (``mesh=None``: one device, every annotation a no-op)."""
    prev = (_ACTIVE.mesh, _ACTIVE.rules)
    _ACTIVE.mesh, _ACTIVE.rules = mesh, rules
    try:
        yield
    finally:
        _ACTIVE.mesh, _ACTIVE.rules = prev


def bind_rules(fn):
    """``fn`` made to run under the ``(mesh, rules)`` installed now,
    whichever thread calls it: autograd recomputes a checkpointed layer
    in the backward, on its own device threads, which do not see this
    thread's rules.  Without a mesh, ``fn`` itself."""
    mesh, rules = _ACTIVE.mesh, _ACTIVE.rules
    if mesh is None:
        return fn

    def run(*args, **kwargs):
        with use_rules(mesh, rules):
            return fn(*args, **kwargs)

    return run


def active():
    """The installed ``(mesh, rules)``."""
    return _ACTIVE.mesh, _ACTIVE.rules


def logical_spec(logical_axes: Sequence[Optional[str]]) -> PartitionSpec:
    """The spec of a tuple of logical axis names (None = replicated),
    resolved against the active mesh."""
    mesh, rules = active()
    if mesh is None:
        return PartitionSpec()
    return PartitionSpec(*(rules.resolve(a, mesh) for a in logical_axes))


def placements(spec: Sequence[Physical], mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(i)`` when entry ``i`` names it, else ``Replicate()``.  A
    tensor dim over several mesh axes is sharded in mesh-dim order, and
    JAX shards it in the tuple's order, so a tuple that is not in mesh
    order raises (as does an axis the mesh lacks, or one named twice)."""
    from torch.distributed.tensor import Replicate, Shard

    names, _ = mesh_axes(mesh)
    out = [Replicate() for _ in names]
    taken = set()
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {tuple(spec)} names axis {a!r}, not in mesh {names}")
            if a in taken:
                raise ValueError(f"spec {tuple(spec)} names axis {a!r} twice")
            taken.add(a)
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(
                f"spec entry {axes} is not in mesh order {names}: DTensor shards a dim over "
                f"several mesh axes in mesh order, JAX in the tuple's order")
        for j in idx:
            out[j] = Shard(i)
    return tuple(out)


def _device_mesh():
    mesh = _ACTIVE.mesh
    if getattr(mesh, "mesh_dim_names", None) is None:
        raise TypeError(f"the active mesh {mesh!r} is not a DeviceMesh: it can plan, not run")
    return mesh


def constrain(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` by logical axes: the
    identity without a mesh.  Under one, the DTensor ``x`` is
    redistributed to the resolved placements; a dim that does not
    divide its axes stays unconstrained (see :meth:`ShardingRules.resolve`),
    and when no dim resolves the constraint is dropped, leaving ``x`` as
    it is laid out (forcing replication there would cost collectives)."""
    mesh = _ACTIVE.mesh
    if mesh is None:
        return x
    return _constrain(x, _device_mesh(), _ACTIVE.rules, logical_axes)


def _constrain(x, mesh, rules: ShardingRules, logical_axes):
    from torch.distributed.tensor import DTensor

    assert len(logical_axes) == x.dim(), (logical_axes, tuple(x.shape))
    resolved = tuple(rules.resolve(a, mesh, d) for a, d in zip(logical_axes, x.shape))
    if all(r is None for r in resolved):
        return x
    if not isinstance(x, DTensor):
        raise TypeError(f"constrain under a mesh takes a DTensor, got {type(x).__name__} "
                        f"{tuple(x.shape)}")
    want = placements(resolved, mesh)
    if tuple(x.placements) == want:
        return x
    # a redistribute keeps the input's strides in the DTensor's metadata
    # while its new local shard is laid out afresh; contiguous() makes the
    # two agree again (a later view, as einsum makes, trusts them)
    return x.redistribute(mesh, want).contiguous()


def unshard_seq(x: torch.Tensor) -> torch.Tensor:
    """An activation ``(B, S, ...)`` with its sequence dim gathered (its
    other placements kept), where a sequence-sharded residual stream meets
    a matmul: before a projection, and before the residual add of a
    projection's output (so that the gradient reaching the projection is
    not sequence-sharded either).  Under a mesh this is the all-gather that
    XLA's partitioner inserts there itself; DTensor would otherwise
    flatten the sharded batch and sequence dims of a matmul into one,
    which torch 2.11 refuses.  The identity without a mesh."""
    if _ACTIVE.mesh is None:
        return x
    from torch.distributed.tensor import Replicate, Shard

    if not any(p == Shard(1) for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if p == Shard(1) else p
                                          for p in x.placements])


def replicated(t: torch.Tensor) -> torch.Tensor:
    """A plain tensor made inside ``forward`` (rotary frequencies,
    positions, zeros) as a replicated DTensor on the active mesh, so that
    it combines with the DTensor activations; the identity without a mesh
    or for a DTensor."""
    mesh = _ACTIVE.mesh
    if mesh is None:
        return t
    return t if hasattr(t, "device_mesh") else replicate_on(t, _device_mesh())


def replicate_on(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t``, which every rank holds alike, as a replicated DTensor on
    ``mesh`` (no collective)."""
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def local_call(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` run on plain tensors.  Under a mesh each
    DTensor argument is gathered to its full value on every rank, ``fn``
    runs locally with no mesh active, and its tensor outputs come back as
    replicated DTensors: for the functions whose ops have no DTensor
    sharding strategy (a sort, a cumsum, a chunk loop).  Every rank
    repeats the whole computation there.  Without a mesh, the plain
    call."""
    mesh = _ACTIVE.mesh
    if mesh is None:
        return fn(*args, **kwargs)
    from torch.distributed.tensor import DTensor, Replicate
    from torch.utils._pytree import tree_map

    dm = _device_mesh()
    rep = [Replicate()] * dm.ndim

    def down(a):
        return a.redistribute(dm, rep).to_local() if isinstance(a, DTensor) else a

    def up(a):
        return replicate_on(a, dm) if isinstance(a, torch.Tensor) else a

    args, kwargs = tree_map(down, (args, kwargs))
    with use_rules(None):  # plain tensors: no annotation applies inside
        out = fn(*args, **kwargs)
    return tree_map(up, out)


def shard_call(fn, in_placements, out_placements, *args):
    """The reference's ``shard_map``: ``fn`` run by each rank on its own
    blocks, with no mesh active.  Each DTensor argument is redistributed
    to its entry of ``in_placements`` and handed over as its local block
    (other arguments as they are); ``fn``'s tensor output, or each of a
    tuple's, comes back as a DTensor with ``out_placements`` (a sequence
    of them for a tuple; ``Partial`` where ranks hold summands).  As ``shard_map``
    sums the cotangents of a replicated input, an input's gradient is
    ``Partial`` on every mesh dim where it is replicated and an output is
    not.  Needs a mesh."""
    from torch.distributed.tensor import DTensor, Partial, Placement

    dm = _device_mesh()
    single = isinstance(out_placements[0], Placement)
    outs = [out_placements] if single else out_placements
    spread = {d for pl in outs for d, p in enumerate(pl) if not p.is_replicate()}

    def down(a, pl):
        if not isinstance(a, DTensor):
            return a
        grad = tuple(Partial() if p.is_replicate() and d in spread else p
                     for d, p in enumerate(pl))
        return a.redistribute(dm, tuple(pl)).to_local(grad_placements=grad)

    local = [down(a, pl) for a, pl in zip(args, in_placements)]
    with use_rules(None):  # plain tensors: no annotation applies inside
        out = fn(*local)
    if single:
        return DTensor.from_local(out, dm, tuple(outs[0]), run_check=False)
    return tuple(DTensor.from_local(o, dm, tuple(pl), run_check=False)
                 for o, pl in zip(out, outs))


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole value of a DTensor (gathered and reduced) as a plain
    tensor; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def embedding_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  Under a mesh the lookup is explicit: each rank
    gathers the rows of its vocab shard (tokens outside it read zero)
    and the partial rows are summed over the vocab's mesh axes, never
    through DTensor's own embedding strategy.  ``table``: a (V, D)
    DTensor replicated or sharded on dim 0; ``tokens``: a (B, S) DTensor
    sharded on dim 0 or replicated.  Returns a (B, S, D) DTensor with the
    tokens' batch placements, replicated elsewhere."""
    mesh = _ACTIVE.mesh
    if mesh is None:
        return table[tokens.long()]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    dm = _device_mesh()
    tokens = replicated(tokens)
    out_pl, final_pl, grad_pl = [], [], []
    for tp, kp in zip(table.placements, tokens.placements):
        if isinstance(tp, Shard):
            if tp.dim != 0 or isinstance(kp, Shard):
                raise ValueError(f"embedding_lookup: table {table.placements} against tokens "
                                 f"{tokens.placements}; the table shards only its vocab dim, "
                                 f"on axes the tokens do not shard")
            out_pl.append(Partial())    # one rank of the axis holds each row
            final_pl.append(Replicate())
            grad_pl.append(tp)
        else:
            out_pl.append(kp)
            final_pl.append(kp)
            # the rows a rank reads are its batch shard's: their gradient
            # is a partial sum over the batch axes
            grad_pl.append(Partial() if isinstance(kp, Shard) else Replicate())
    tok = tokens.to_local().long()
    tab = table.to_local(grad_placements=grad_pl)
    if any(isinstance(tp, Shard) for tp in table.placements):
        idx = tok - local_offset(table)[0]
        inside = (idx >= 0) & (idx < tab.shape[0])
        rows = tab[torch.where(inside, idx, 0)] * inside[..., None].to(tab.dtype)
    else:
        rows = tab[tok]
    out = DTensor.from_local(rows, dm, out_pl, run_check=False)
    return out.redistribute(dm, final_pl)


def take_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` elementwise: ``torch.gather`` along the last dim
    of the entries ``idx`` names (``idx`` has ``x``'s leading shape).
    Under a mesh the gather is explicit, as :func:`embedding_lookup`'s:
    each rank picks the entries of its shard of the last dim (zero
    outside it), the picks are summed over the axes that shard that dim,
    and ``idx`` is placed as ``x``'s leading dims are."""
    mesh = _ACTIVE.mesh
    if mesh is None:
        return torch.gather(x, -1, idx.long()[..., None])[..., 0]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    dm = _device_mesh()
    last = x.dim() - 1
    x_pl = [p if isinstance(p, Shard) else Replicate() for p in x.placements]
    idx_pl = [p if isinstance(p, Shard) and p.dim < last else Replicate() for p in x_pl]
    out_pl = [Partial() if p == Shard(last) else q for p, q in zip(x_pl, idx_pl)]
    x = x.redistribute(dm, x_pl)
    xl = x.to_local()
    il = replicated(idx).redistribute(dm, idx_pl).to_local().long()
    if any(p == Shard(last) for p in x_pl):
        il = il - local_offset(x)[last]
        inside = (il >= 0) & (il < xl.shape[-1])
        picked = torch.gather(xl, -1, torch.where(inside, il, 0)[..., None])[..., 0]
        picked = picked * inside.to(picked.dtype)
    else:
        picked = torch.gather(xl, -1, il[..., None])[..., 0]
    out = DTensor.from_local(picked, dm, out_pl, run_check=False)
    return out.redistribute(dm, idx_pl)


def local_offset(t) -> Tuple[int, ...]:
    """The global index of a DTensor's local shard's first element."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    _, offset = compute_local_shape_and_global_offset(t.shape, t.device_mesh, t.placements)
    return tuple(offset)


# ---------------------------------------------------------------------------
# parameter partitioning by path
# ---------------------------------------------------------------------------

#: path-substring -> logical axes for the *trailing* dims (leading stacked
#: layer dims are never sharded).  First match wins.
_PARAM_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    # replicated small parameters must match before family catch-alls
    ("norm", (None,)),
    ("bias", (None,)),
    ("mu_", (None,)),
    ("/w0", (None,)),
    ("/u", (None, None)),
    ("lora_a", (None, None)),
    ("conv", (None, None)),
    ("A_log", (None,)),
    ("dt_", (None,)),
    ("/D", (None,)),
    ("embed/vocab", ("vocab", "fsdp")),
    ("lm_head", ("fsdp", "vocab")),
    ("attn/wqkv", ("fsdp", "heads")),
    ("attn/wq", ("fsdp", "heads")),
    ("attn/wk", ("fsdp", "heads")),
    ("attn/wv", ("fsdp", "heads")),
    ("attn/wo", ("heads", "fsdp")),
    ("mlp/w_in", ("fsdp", "d_ff")),
    ("mlp/w_gate", ("fsdp", "d_ff")),
    ("mlp/w_out", ("d_ff", "fsdp")),
    ("moe/router", ("fsdp", None)),
    ("moe/w_in", ("expert", "fsdp", "d_ff")),
    ("moe/w_gate", ("expert", "fsdp", "d_ff")),
    ("moe/w_out", ("expert", "d_ff", "fsdp")),
    ("ssm/in_proj", ("fsdp", "heads")),
    ("ssm/out_proj", ("heads", "fsdp")),
    ("ln_", (None,)),
    ("rwkv/ck", ("fsdp", "d_ff")),
    ("rwkv/cv", ("d_ff", "fsdp")),
    ("rwkv/wo", ("heads", "fsdp")),
    ("rwkv/", ("fsdp", "heads")),
)


def param_logical_axes(path: str, ndim: int) -> Tuple[Optional[str], ...]:
    """Logical axes for a parameter; unmatched paths are replicated."""
    for key, trailing in _PARAM_RULES:
        if key in path:
            t = trailing[-ndim:] if len(trailing) >= ndim else trailing
            lead = ndim - len(t)
            return (None,) * lead + tuple(t)
    return (None,) * ndim


def param_partition_spec(path: str, ndim: int, rules: ShardingRules, mesh,
                         shape=None) -> PartitionSpec:
    axes = param_logical_axes(path, ndim)
    dims = shape if shape is not None else (None,) * ndim
    return PartitionSpec(*(rules.resolve(a, mesh, d) for a, d in zip(axes, dims)))


def tree_paths(tree) -> Dict[str, object]:
    """Flatten a nested dict into ``{'a/b/c': leaf}`` with '/'-joined keys."""
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else k, v)
        else:
            flat[prefix] = node

    walk("", tree)
    return flat


def tree_partition_specs(tree, rules: ShardingRules, mesh):
    """A nested dict of leaves with ``ndim`` and ``shape`` (tensors) ->
    the matching nested dict of :class:`PartitionSpec` s, divisibility-
    checked against the leaf shapes."""
    def walk(prefix, node):
        if isinstance(node, dict):
            return {k: walk(f"{prefix}/{k}" if prefix else k, v) for k, v in node.items()}
        shape = tuple(node.shape)
        return param_partition_spec(prefix, len(shape), rules, mesh, shape)

    return walk("", tree)


def param_specs(model, rules: ShardingRules, mesh) -> Dict[str, PartitionSpec]:
    """The reference's spec of every parameter of a port ``Model``, by
    port name.  A per-layer leaf (``layers.3.attn.wq``) takes the spec of
    its stacked reference path (``layers/attn/wq`` at rank + 1, the layer
    count leading) without that leading entry, which the rules never
    shard; the hybrid's ``shared`` block and every other leaf are their
    own paths."""
    from repro_torch.models.model import _split_name, _stack_len

    cfg = model.cfg
    out: Dict[str, PartitionSpec] = {}
    for name, p in model.named_parameters():
        ref, stack, _ = _split_name(name)
        path = ref.replace(".", "/")
        if stack is None:
            out[name] = param_partition_spec(path, p.dim(), rules, mesh, tuple(p.shape))
            continue
        shape = (_stack_len(cfg, stack), *p.shape)
        spec = param_partition_spec(path, len(shape), rules, mesh, shape)
        if spec[0] is not None:
            raise AssertionError(f"{name}: the layer axis of {path} resolved to {spec[0]!r}")
        out[name] = PartitionSpec(*spec[1:])
    return out


def param_placements(model, rules: ShardingRules, mesh) -> Dict[str, tuple]:
    """:func:`param_specs` as DTensor placements on ``mesh``."""
    return {name: placements(spec, mesh) for name, spec in param_specs(model, rules, mesh).items()}


# ---------------------------------------------------------------------------
# placing tensors and models on a mesh
# ---------------------------------------------------------------------------

class Sharding(NamedTuple):
    """Where a leaf lives: a ``DeviceMesh`` and the DTensor placements on
    it (the reference's ``NamedSharding``)."""

    mesh: Any
    placements: tuple


def distribute(t: torch.Tensor, mesh, placements_: Sequence) -> torch.Tensor:
    """A tensor every rank holds alike, as a DTensor with ``placements_``
    on ``mesh``: each rank keeps its own chunk, with no collective."""
    return replicate_on(t, mesh).redistribute(mesh, tuple(placements_))


def shard_model(model, mesh, rules: ShardingRules = DEFAULT_RULES):
    """Replace every parameter of a port ``Model`` by a DTensor placed by
    :func:`param_placements` (each rank keeps its chunk of the value it
    holds).  Returns ``model``."""
    pl = param_placements(model, rules, mesh)
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        module = model.get_submodule(owner) if owner else model
        module._parameters[leaf] = torch.nn.Parameter(
            distribute(p.detach(), mesh, pl[name]), requires_grad=p.requires_grad)
    return model
