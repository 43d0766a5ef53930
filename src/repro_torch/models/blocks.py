"""Per-layer blocks: GQA attention (bias, qk-norm, sliding window, RoPE
or M-RoPE), the gated-MLP residual, the top-k mixture of experts with
GShard's grouped capacity dispatch, the encoder-decoder cross-attention,
and the recurrent blocks, Mamba2 (SSD, a scalar decay per head) and
RWKV6 (a data-dependent decay per channel), full-sequence and
single-token decode.

The port of the reference's ``repro.models.blocks``.  Parameters live
in :class:`torch.nn.Module` s whose attribute names are the reference's
dict keys (``attn.wq``, ``mlp.w_gate``, ...); the blocks
themselves are plain functions ``block(p, x, ...)`` over those modules,
as the reference's are over dicts.  The reference's sharding
annotations stand at its sites (``constrain``, a no-op without a mesh).
Under a mesh, Mamba2's mixing between its projections (:func:`_mamba_mix`)
and RWKV6's chunked recurrence run through ``local_call`` (gathered, on
every rank), since DTensor has no sharding strategy for their cumsums,
splits and chunk loops; the MoE's routing and experts and the recurrent
decode steps run on each rank's blocks (``shard_call``), as the
reference's ``shard_map`` would, which also keeps DTensor's sharding
propagation away from their many-operand products; a sequence-sharded
activation is gathered (``unshard_seq``) before it meets a projection or
takes a projection's output in a residual add.
"""

from __future__ import annotations

import functools
import math
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (
    active,
    constrain,
    local_call,
    local_offset,
    placements,
    replicated,
    shard_call,
    unshard_seq,
)
from repro_torch.models import linear_attn as la
from repro_torch.models.layers import (
    _ACTIVATIONS,
    decode_attention,
    flash_attention,
    gated_mlp,
    init_dense,
    init_norm,
    mrope,
    ring_update,
    rms_norm,
    rope,
)

__all__ = [
    "CACHE_UPDATES",
    "Attention",
    "CrossAttention",
    "DenseBlock",
    "MLP",
    "MoE",
    "MoEBlock",
    "Mamba2",
    "Mamba2Block",
    "RWKV6",
    "RWKV6Block",
    "attention",
    "attention_decode",
    "cross_attention",
    "dense_block",
    "dense_block_decode",
    "encode_kv",
    "init_cross_attention",
    "init_dense_block",
    "init_mamba2_block",
    "init_moe_block",
    "init_rwkv6_block",
    "mamba2_block",
    "mamba2_block_decode",
    "moe_block",
    "moe_block_decode",
    "moe_ffn",
    "moe_route",
    "recording_routes",
    "rwkv6_block",
    "rwkv6_block_decode",
]

#: the decode KV-cache write modes (``ModelConfig.cache_update``)
CACHE_UPDATES = ("dus", "ring", "onehot", "deferred")


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


# ===========================================================================
# attention (GQA + bias + qk_norm + SWA + RoPE)
# ===========================================================================

class Attention(nn.Module):
    """The attention sub-block's parameters: ``norm``, ``wq``, ``wk``,
    ``wv``, ``wo`` (each ``(d_in, d_out)``), the ``bias_*`` under
    ``qkv_bias`` and ``q_norm``/``k_norm`` under ``qk_norm``."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
        e = lambda *shape: _param(torch.empty(shape, dtype=dtype, device=device))  # noqa: E731
        self.norm = e(D)
        self.wq = e(D, H * hd)
        self.wk = e(D, KV * hd)
        self.wv = e(D, KV * hd)
        self.wo = e(H * hd, D)
        if cfg.qkv_bias:
            self.bias_q = e(H * hd)
            self.bias_k = e(KV * hd)
            self.bias_v = e(KV * hd)
        if cfg.qk_norm:
            self.q_norm = e(hd)
            self.k_norm = e(hd)

    @torch.no_grad()
    def reset(self, gen: torch.Generator, cfg: ModelConfig) -> None:
        """The reference's ``_init_attn``: unit norms, scaled-normal
        projections drawn in the order wq, wk, wv, wo, zero biases."""
        D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
        dt, dev = self.wq.dtype, self.wq.device
        self.norm.copy_(init_norm(D, dt, dev))
        self.wq.copy_(init_dense(gen, D, H * hd, dt, dev))
        self.wk.copy_(init_dense(gen, D, KV * hd, dt, dev))
        self.wv.copy_(init_dense(gen, D, KV * hd, dt, dev))
        self.wo.copy_(init_dense(gen, H * hd, D, dt, dev))
        if cfg.qkv_bias:
            for b in (self.bias_q, self.bias_k, self.bias_v):
                b.zero_()
        if cfg.qk_norm:
            self.q_norm.fill_(1)
            self.k_norm.fill_(1)


def _split_heads(t: torch.Tensor, H: int, hd: int) -> torch.Tensor:
    """``t`` ``(..., H * hd)`` as ``(..., H, hd)``.  Under a mesh whose
    shards of the last dim would split a head (14 heads on a model axis
    of 16), that dim is gathered first: DTensor refuses such a view."""
    if active()[0] is not None:
        from torch.distributed.tensor import Replicate

        last = t.dim() - 1
        ways = math.prod(t.device_mesh.size(d) for d, q in enumerate(t.placements)
                         if q.is_shard(last))
        if H % ways:
            t = t.redistribute(t.device_mesh, [Replicate() if q.is_shard(last) else q
                                               for q in t.placements])
    return t.reshape(*t.shape[:-1], H, hd)


def _merge_heads(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``o`` ``(..., H, hd)`` with its heads merged, times ``wo`` ``(H *
    hd, D)``.  Under a mesh whose shards of ``wo``'s rows would split a
    head, those rows are gathered first: the backward would otherwise
    split the sharded gradient of the merged ``o`` into heads, a view
    DTensor refuses (see :func:`_split_heads`)."""
    H = o.shape[-2]
    if active()[0] is not None:
        from torch.distributed.tensor import Replicate

        ways = math.prod(wo.device_mesh.size(d) for d, q in enumerate(wo.placements)
                         if q.is_shard(0))
        if H % ways:
            wo = wo.redistribute(wo.device_mesh, [Replicate() if q.is_shard(0) else q
                                                  for q in wo.placements])
    return o.reshape(*o.shape[:-2], -1) @ wo


def _project_qkv(p: Attention, x: torch.Tensor, cfg: ModelConfig):
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bias_q, k + p.bias_k, v + p.bias_v
    q, k, v = _split_heads(q, H, hd), _split_heads(k, KV, hd), _split_heads(v, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    return q, k, v


def _apply_rope(q, k, cfg: ModelConfig, positions):
    if cfg.mrope:
        return mrope(q, k, positions, cfg.mrope_sections, cfg.rope_theta)
    return rope(q, k, positions, cfg.rope_theta)


def attention(p: Attention, x: torch.Tensor, cfg: ModelConfig, positions, *, causal=True):
    """Full-sequence attention (training / prefill shapes).  positions:
    (B, S) int, or (3, B, S) under M-RoPE.  Returns ``(x + o, (k, v))``."""
    h = unshard_seq(rms_norm(x, p.norm, cfg.norm_eps))
    q, k, v = _project_qkv(p, h, cfg)
    q, k = _apply_rope(q, k, cfg, positions)
    q = constrain(q, "batch", None, "heads", None)
    k = constrain(k, "batch", None, "heads", None)
    o = flash_attention(q, k, v, causal=causal, window=cfg.sliding_window)
    o = _merge_heads(o, p.wo)
    return unshard_seq(x) + o, (k, v)


def attention_decode(p: Attention, x: torch.Tensor, cfg: ModelConfig, k_cache, v_cache, t,
                     positions, kpos: Optional[torch.Tensor] = None):
    """Single-token attention against the cache.  x: (B, 1, D); caches:
    (B, S, KV, hd); t: the current position; kpos: (S,) absolute position
    of each slot including the current token (the rolling ring buffer of
    a sliding window), or None for a plain arange cache.

    The write goes to slot ``t % S`` by ``cfg.cache_update``: ``dus`` and
    ``ring`` write the one row in place, ``onehot`` rewrites the cache
    through a one-hot mask (the naive baseline; the result is copied into
    the cache's storage), and ``deferred`` writes nothing and returns the
    new ``(k, v)`` rows for the caller's one write for all layers.
    Returns ``(x + o, (k_cache, v_cache))`` (or the rows under
    ``deferred``)."""
    h = rms_norm(x, p.norm, cfg.norm_eps)
    q, k, v = _project_qkv(p, h, cfg)
    q, k = _apply_rope(q, k, cfg, positions)
    S = k_cache.shape[1]
    slot = int(t) % S
    if cfg.cache_update == "deferred":
        o = decode_attention(
            q, k_cache.to(q.dtype), v_cache.to(q.dtype), t,
            window=cfg.sliding_window, kpos=kpos, current=(k, v),
        )
        o = _merge_heads(o, p.wo)
        return x + o, (k, v)
    if cfg.cache_update in ("ring", "dus"):
        ring_update(k_cache, k, slot)
        ring_update(v_cache, v, slot)
    elif cfg.cache_update == "onehot":
        onehot = replicated(torch.arange(S, device=x.device) == slot).to(k_cache.dtype)
        onehot = onehot[None, :, None, None]
        k_cache.copy_(k_cache * (1 - onehot) + k.to(k_cache.dtype) * onehot)
        v_cache.copy_(v_cache * (1 - onehot) + v.to(v_cache.dtype) * onehot)
    else:
        raise ValueError(f"unknown cache_update {cfg.cache_update!r}; expected one of "
                         f"{CACHE_UPDATES}")
    o = decode_attention(
        q, k_cache.to(q.dtype), v_cache.to(q.dtype), t,
        window=cfg.sliding_window, kpos=kpos,
    )
    o = _merge_heads(o, p.wo)
    return x + o, (k_cache, v_cache)


# ===========================================================================
# dense transformer block
# ===========================================================================

class MLP(nn.Module):
    """The gated-MLP sub-block's parameters: ``norm``, ``w_gate``,
    ``w_in``, ``w_out``."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        D, F = cfg.d_model, cfg.d_ff
        e = lambda *shape: _param(torch.empty(shape, dtype=dtype, device=device))  # noqa: E731
        self.norm = e(D)
        self.w_gate = e(D, F)
        self.w_in = e(D, F)
        self.w_out = e(F, D)

    @torch.no_grad()
    def reset(self, gen: torch.Generator, cfg: ModelConfig) -> None:
        D, F = cfg.d_model, cfg.d_ff
        dt, dev = self.w_in.dtype, self.w_in.device
        self.norm.copy_(init_norm(D, dt, dev))
        self.w_gate.copy_(init_dense(gen, D, F, dt, dev))
        self.w_in.copy_(init_dense(gen, D, F, dt, dev))
        self.w_out.copy_(init_dense(gen, F, D, dt, dev))


class DenseBlock(nn.Module):
    """One dense layer: ``attn`` and ``mlp``."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.attn = Attention(cfg, dtype, device)
        self.mlp = MLP(cfg, dtype, device)

    def reset(self, gen: torch.Generator, cfg: ModelConfig) -> None:
        self.attn.reset(gen, cfg)
        self.mlp.reset(gen, cfg)


def init_dense_block(gen: torch.Generator, cfg: ModelConfig, dtype, device=None) -> DenseBlock:
    """A dense layer on ``device`` (``gen``'s by default), initialized
    from ``gen``."""
    blk = DenseBlock(cfg, dtype, device if device is not None else gen.device)
    blk.reset(gen, cfg)
    return blk


def _mlp_res(p: MLP, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = unshard_seq(rms_norm(x, p.norm, cfg.norm_eps))
    return unshard_seq(x) + gated_mlp(p, h, cfg.activation)


def dense_block(p: DenseBlock, x: torch.Tensor, cfg: ModelConfig, positions, *, causal=True):
    """Returns ``(x, (aux, (k, v)))``: aux is the reference's float32 zero."""
    x, kv = attention(p.attn, x, cfg, positions, causal=causal)
    x = constrain(x, "batch", "seq", None)
    x = _mlp_res(p.mlp, x, cfg)
    return x, (_zero(x), kv)


def _zero(x: torch.Tensor) -> torch.Tensor:
    """The reference's float32 zero aux, on ``x``'s device (and mesh)."""
    return replicated(torch.zeros((), dtype=torch.float32, device=x.device))


def dense_block_decode(p: DenseBlock, x: torch.Tensor, cfg: ModelConfig, k_cache, v_cache, t,
                       positions, kpos=None):
    x, (k_cache, v_cache) = attention_decode(
        p.attn, x, cfg, k_cache, v_cache, t, positions, kpos
    )
    x = _mlp_res(p.mlp, x, cfg)
    return x, (k_cache, v_cache)


# ===========================================================================
# cross-attention (encoder-decoder)
# ===========================================================================

class CrossAttention(Attention):
    """A decoder layer's cross-attention: the attention sub-block's
    parameters (the reference's ``init_cross_attention`` is its
    ``_init_attn``); the biases are never applied."""


def init_cross_attention(gen: torch.Generator, cfg: ModelConfig, dtype,
                         device=None) -> CrossAttention:
    p = CrossAttention(cfg, dtype, device if device is not None else gen.device)
    p.reset(gen, cfg)
    return p


def cross_attention(p: CrossAttention, x: torch.Tensor, cfg: ModelConfig, enc_kv):
    """Decoder cross-attention, non-causal; ``enc_kv = (k, v)``
    precomputed from the encoder output (:func:`encode_kv`), each
    ``(B, S_enc, KV, hd)``."""
    h = unshard_seq(rms_norm(x, p.norm, cfg.norm_eps))
    H, hd = cfg.num_heads, cfg.hd
    q = _split_heads(h @ p.wq, H, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
    k, v = enc_kv
    o = flash_attention(q, k, v, causal=False)
    return unshard_seq(x) + _merge_heads(o, p.wo)


def encode_kv(p: CrossAttention, enc_out: torch.Tensor, cfg: ModelConfig):
    """Cross-attention K/V from the encoder output (once per sequence;
    every decode step reuses them): ``(B, S_enc, KV, hd)`` each."""
    KV, hd = cfg.num_kv_heads, cfg.hd
    enc_out = unshard_seq(enc_out)
    k = _split_heads(enc_out @ p.wk, KV, hd)
    v = _split_heads(enc_out @ p.wv, KV, hd)
    if cfg.qk_norm:
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    return k, v


# ===========================================================================
# MoE block (top-k, GShard-style grouped capacity dispatch)
# ===========================================================================

class MoE(nn.Module):
    """The expert sub-block's parameters: ``norm``, the float32
    ``router`` (D, E) (float32 in every model dtype, as the reference's),
    and the experts' ``w_gate``/``w_in`` (E, D, F) and ``w_out`` (E, F, D)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        D, Fd, E = cfg.d_model, cfg.d_ff, cfg.num_experts
        e = lambda *shape, dt=dtype: _param(torch.empty(shape, dtype=dt, device=device))  # noqa: E731
        self.norm = e(D)
        self.router = e(D, E, dt=torch.float32)
        self.w_gate = e(E, D, Fd)
        self.w_in = e(E, D, Fd)
        self.w_out = e(E, Fd, D)

    @torch.no_grad()
    def reset(self, gen: torch.Generator, cfg: ModelConfig) -> None:
        """Unit norm; the router, then each expert tensor drawn whole:
        standard normal in float32 scaled by ``1/sqrt(d_in)`` (D for
        ``w_gate``/``w_in``, F for ``w_out``)."""
        D, Fd, E = cfg.d_model, cfg.d_ff, cfg.num_experts
        dt, dev = self.w_in.dtype, self.w_in.device
        self.norm.copy_(init_norm(D, dt, dev))
        self.router.copy_(init_dense(gen, D, E, torch.float32, dev))
        for w, din, dout in ((self.w_gate, D, Fd), (self.w_in, D, Fd), (self.w_out, Fd, D)):
            draw = torch.randn((E, din, dout), generator=gen, dtype=torch.float32, device=dev)
            w.copy_((draw * (1.0 / math.sqrt(din))).to(dt))


class MoEBlock(nn.Module):
    """One MoE layer: ``attn`` and ``moe``."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.attn = Attention(cfg, dtype, device)
        self.moe = MoE(cfg, dtype, device)

    def reset(self, gen: torch.Generator, cfg: ModelConfig) -> None:
        self.attn.reset(gen, cfg)
        self.moe.reset(gen, cfg)


def init_moe_block(gen: torch.Generator, cfg: ModelConfig, dtype, device=None) -> MoEBlock:
    blk = MoEBlock(cfg, dtype, device if device is not None else gen.device)
    blk.reset(gen, cfg)
    return blk


_ROUTES: Optional[List[Dict[str, torch.Tensor]]] = None


@contextmanager
def recording_routes() -> Iterator[List[Dict[str, torch.Tensor]]]:
    """Collect the routing of every :func:`moe_route` call made inside
    the block, in call order (a forward: one entry a layer; a decode
    step: one a layer, step after step): each entry holds ``probs``
    (B, n, gs, E), ``gate_idx`` (B, n, gs, K) and ``keep`` (B, n, gs, K,
    E).  Nothing is recorded outside it."""
    global _ROUTES
    prev, _ROUTES = _ROUTES, []
    try:
        yield _ROUTES
    finally:
        _ROUTES = prev


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: the ``k`` largest, ties broken
    towards the lower index (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_route(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """GShard's grouped top-k routing with capacity for ``x`` (B, S, D).

    Groups are (batch, seq-block) pairs of ``gs = min(moe_group_size,
    S)`` tokens (``S`` must be a multiple of ``gs``, as the reference's
    reshape demands); each expert takes at most ``cap = max(int(gs * K /
    E * moe_capacity_factor), 1)`` of a group's (token, choice) pairs,
    counted token-major then by choice, and the rest are dropped.
    Everything is float32.  Returns ``xg`` (B, n, gs, D), ``gate_idx``
    (B, n, gs, K), ``keep`` (B, n, gs, K, E), ``slot`` (B, n, gs, K)
    int32, ``dispatch`` and ``combine`` (B, n, gs, E, cap; ``combine``
    weighted by the gate values renormalized over the K choices),
    ``cap`` and the load-balancing ``aux``.  Under a mesh each rank routes
    the groups of its own block of ``xg`` (:func:`_moe_groups`)."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    gs = min(cfg.moe_group_size, S)
    if S % gs:
        raise ValueError(f"MoE routing needs the sequence ({S}) to be a multiple of the "
                         f"group size min(moe_group_size, S) = {gs}")
    nsb = S // gs
    xg = x.reshape(B, nsb, gs, D)
    cap = max(int(gs * K / E * cfg.moe_capacity_factor), 1)
    if active()[0] is None:
        return {"xg": xg, **_route(p.router, xg, E, K, cap), "cap": cap}
    from torch.distributed.tensor import Partial, Replicate

    xg_pl = _moe_groups(cfg, xg.shape)
    rep = [Replicate()] * len(xg_pl)
    # each rank's share of the groups: its aux (a mean over its groups)
    # scaled by it is a summand of the global mean
    frac = 1.0 / math.prod(xg.device_mesh.size(d) for d, q in enumerate(xg_pl) if q.is_shard())
    keys = ("gate_idx", "keep", "slot", "dispatch", "combine", "aux")

    def route(router, xg_local):
        r = _route(router, xg_local, E, K, cap)
        r["aux"] = r["aux"] * frac
        return tuple(r[k] for k in keys)

    aux_pl = [Partial() if q.is_shard() else q for q in xg_pl]
    out = dict(zip(keys, shard_call(route, [rep, xg_pl], [xg_pl] * 5 + [aux_pl],
                                    p.router, xg)))
    out["aux"] = out["aux"].redistribute(xg.device_mesh, rep)
    return {"xg": xg.redistribute(xg.device_mesh, xg_pl), **out, "cap": cap}


def _moe_groups(cfg: ModelConfig, shape) -> tuple:
    """Where the MoE's groups ``(B, n, gs, D)`` live under the active
    mesh: the batch rows on the batch axes, the sequence blocks gathered
    under ``moe_parallel="tp"`` (the expert hidden is sharded instead)
    and sharded on the sequence axes under ``"dp"``, as the reference's
    constraint of the expert inputs places them."""
    mesh, rules = active()
    seq = "seq" if cfg.moe_parallel == "dp" else None
    return placements(tuple(rules.resolve(a, mesh, d)
                            for a, d in zip(("batch", seq, None, None), shape)), mesh)


def _route(router: torch.Tensor, xg: torch.Tensor, E: int, K: int, cap: int):
    """:func:`moe_route`'s routing of the groups ``xg`` (B, n, gs, D)."""
    B, nsb, gs, _ = xg.shape
    logits = torch.einsum("bnsd,de->bnse", xg.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    density = probs.mean(dim=2)                                  # (B, n, E)
    top1 = F.one_hot(probs.argmax(dim=-1), E).float()
    density_hard = top1.mean(dim=2)
    aux = E * torch.mean(torch.sum(density * density_hard, dim=-1))

    gate_vals, gate_idx = _top_k(probs, K)                        # (B, n, gs, K)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    onehot = F.one_hot(gate_idx, E).float()                       # (B, n, gs, K, E)
    flat = onehot.reshape(B, nsb, gs * K, E)
    pos = torch.cumsum(flat, dim=2) - flat
    pos = pos.reshape(B, nsb, gs, K, E)
    keep = (pos < cap).float() * onehot
    slot = (pos * keep).sum(dim=-1).to(torch.int32)
    slot_oh = F.one_hot(slot.long(), cap).float()
    dispatch = torch.einsum("bnske,bnskc->bnsec", keep, slot_oh)
    combine = torch.einsum("bnsk,bnske,bnskc->bnsec", gate_vals, keep, slot_oh)
    if _ROUTES is not None:
        _ROUTES.append({"probs": probs, "gate_idx": gate_idx, "keep": keep})
    return {"gate_idx": gate_idx, "keep": keep, "slot": slot, "dispatch": dispatch,
            "combine": combine, "aux": aux}


def moe_ffn(p: MoE, x: torch.Tensor, cfg: ModelConfig):
    """The experts on :func:`moe_route`'s dispatch: each expert's gated
    MLP over its ``cap`` slots of every group, combined back with the
    gate weights (dropped tokens get zero).  The dispatch product is
    float32, the expert products in the model's dtype.  Returns ``(y
    (B, S, D), aux)``.  Under a mesh each rank runs its groups through
    its blocks of the experts (:func:`_experts_on_shards`)."""
    B, S, D = x.shape
    r = moe_route(p, x, cfg)
    if active()[0] is None:
        y = _experts(r["dispatch"], r["combine"], r["xg"], p.w_gate, p.w_in, p.w_out,
                     activation=cfg.activation)
    else:
        y = _experts_on_shards(p, r, cfg)
    return y.reshape(B, S, D), r["aux"]


def _experts(dispatch, combine, xg, w_gate, w_in, w_out, *, activation: str):
    """The expert products of :func:`moe_ffn` on plain tensors."""
    dt = xg.dtype
    xin = torch.einsum("bnsec,bnsd->ebncd", dispatch, xg.float()).to(dt)
    act = _ACTIVATIONS[activation]
    h = act(torch.einsum("ebncd,edf->ebncf", xin, w_gate)) * torch.einsum(
        "ebncd,edf->ebncf", xin, w_in)
    out = torch.einsum("ebncf,efd->ebncd", h, w_out)
    return torch.einsum("bnsec,ebncd->bnsd", combine.to(dt), out)


def _experts_on_shards(p: MoE, r, cfg: ModelConfig) -> torch.Tensor:
    """:func:`moe_ffn`'s experts under a mesh, each rank on plain
    tensors (the reference's constraints, written out): its groups, as
    :func:`_moe_groups` places them, against its blocks of the experts,
    whose hidden dim is sharded on the ``"d_ff"`` axes under ``"tp"``
    (gathered under ``"dp"``), the expert dim on the ``"expert"`` axes
    and the model dim gathered.  A rank's output is then a summand over
    the expert and hidden shards, summed across them once (an
    all-reduce of the ``(B, n, gs, D)`` output)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh, rules = active()
    ff = None if cfg.moe_parallel == "dp" else "d_ff"

    def pl(axes, t):
        return placements(tuple(rules.resolve(a, mesh, d) for a, d in zip(axes, t.shape)), mesh)

    xg_pl = _moe_groups(cfg, r["xg"].shape)
    route_pl = list(xg_pl)
    w_in_pl = pl(("expert", None, ff), p.w_gate)
    w_out_pl = pl(("expert", ff, None), p.w_out)
    for d, (q, w) in enumerate(zip(xg_pl, w_in_pl)):
        if q.is_shard() and w.is_shard():
            raise ValueError(f"mesh dim {d} shards both the MoE groups and the experts")
        if w.is_shard(0):
            route_pl[d] = Shard(3)  # the dispatch's expert dim, as the weights'
    y_pl = [Partial() if w.is_shard() else q for q, w in zip(xg_pl, w_in_pl)]
    y = shard_call(functools.partial(_experts, activation=cfg.activation),
                   [route_pl, route_pl, xg_pl, w_in_pl, w_in_pl, w_out_pl], y_pl,
                   r["dispatch"], r["combine"], r["xg"], p.w_gate, p.w_in, p.w_out)
    return y.redistribute(y.device_mesh, [Replicate() if q.is_partial() else q for q in y_pl])


def moe_block(p: MoEBlock, x: torch.Tensor, cfg: ModelConfig, positions, *, causal=True):
    """Returns ``(x, (aux, (k, v)))``."""
    x, kv = attention(p.attn, x, cfg, positions, causal=causal)
    x = constrain(x, "batch", "seq", None)
    h = unshard_seq(rms_norm(x, p.moe.norm, cfg.norm_eps))
    y, aux = moe_ffn(p.moe, h, cfg)
    return unshard_seq(x) + y, (aux, kv)


def moe_block_decode(p: MoEBlock, x: torch.Tensor, cfg: ModelConfig, k_cache, v_cache, t,
                     positions, kpos=None):
    """One token: groups of one, so ``cap = 1`` and nothing drops."""
    x, (k_cache, v_cache) = attention_decode(
        p.attn, x, cfg, k_cache, v_cache, t, positions, kpos
    )
    h = rms_norm(x, p.moe.norm, cfg.norm_eps)
    y, _ = moe_ffn(p.moe, h, cfg)
    return x + y, (k_cache, v_cache)


# ===========================================================================
# Mamba2 block (SSD with a scalar decay per head)
# ===========================================================================

def _mamba_dims(cfg: ModelConfig):
    d_inner = 2 * cfg.d_model
    H = d_inner // cfg.ssm_head_dim
    ds = cfg.ssm_state
    conv_ch = d_inner + 2 * ds
    return d_inner, H, ds, conv_ch


class Mamba2(nn.Module):
    """The Mamba2 sub-block's parameters: ``norm``, ``in_proj`` (D, 2
    d_inner + 2 ssm_state + H: z, xBC, dt), the depthwise causal conv's
    ``conv_w`` (width, conv_ch) and ``conv_bias``, ``A_log``, ``dt_bias``
    and ``skip_D`` (H; float32 in every model dtype, as the reference's),
    ``out_norm`` (d_inner) and ``out_proj`` (d_inner, D)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d_inner, H, ds, conv_ch = _mamba_dims(cfg)
        D = cfg.d_model
        e = lambda *shape, dt=dtype: _param(torch.empty(shape, dtype=dt, device=device))  # noqa: E731
        self.norm = e(D)
        self.in_proj = e(D, 2 * d_inner + 2 * ds + H)
        self.conv_w = e(cfg.ssm_conv_width, conv_ch)
        self.conv_bias = e(conv_ch)
        self.A_log = e(H, dt=torch.float32)
        self.dt_bias = e(H, dt=torch.float32)
        self.skip_D = e(H, dt=torch.float32)
        self.out_norm = e(d_inner)
        self.out_proj = e(d_inner, D)

    @torch.no_grad()
    def reset(self, gen: torch.Generator, cfg: ModelConfig) -> None:
        """The reference's distributions, drawn in the order in_proj,
        conv_w, out_proj: unit norms, ``conv_w`` a float32 normal times
        0.2, a zero ``conv_bias``, ``A_log = 0`` (A = -1), ``dt_bias = 0``,
        ``skip_D = 1``."""
        d_inner, H, ds, conv_ch = _mamba_dims(cfg)
        D = cfg.d_model
        dt, dev = self.in_proj.dtype, self.in_proj.device
        self.norm.copy_(init_norm(D, dt, dev))
        self.in_proj.copy_(init_dense(gen, D, 2 * d_inner + 2 * ds + H, dt, dev))
        conv = torch.randn((cfg.ssm_conv_width, conv_ch), generator=gen, dtype=torch.float32,
                           device=dev)
        self.conv_w.copy_((conv * 0.2).to(dt))
        self.conv_bias.zero_()
        self.A_log.zero_()
        self.dt_bias.zero_()
        self.skip_D.fill_(1)
        self.out_norm.copy_(init_norm(d_inner, dt, dev))
        self.out_proj.copy_(init_dense(gen, d_inner, D, dt, dev))


class Mamba2Block(nn.Module):
    """One Mamba2 layer: ``ssm``."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.ssm = Mamba2(cfg, dtype, device)

    def reset(self, gen: torch.Generator, cfg: ModelConfig) -> None:
        self.ssm.reset(gen, cfg)


def init_mamba2_block(gen: torch.Generator, cfg: ModelConfig, dtype, device=None) -> Mamba2Block:
    blk = Mamba2Block(cfg, dtype, device if device is not None else gen.device)
    blk.reset(gen, cfg)
    return blk


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d.  x: (B, S, C); w: (width, C); b: (C,).
    ``width`` shifted multiply-adds in float32, rounded to ``x``'s dtype
    once, then the bias added in it (the reference's conv in ``x``'s
    dtype, then ``+ b``)."""
    width = w.shape[0]
    S = x.shape[1]
    xp = F.pad(x.float(), (0, 0, width - 1, 0))          # width - 1 zeros before
    wf = w.float()
    out = xp[:, :S] * wf[0]
    for j in range(1, width):
        out = out + xp[:, j:j + S] * wf[j]
    return out.to(x.dtype) + b.to(x.dtype)


def _mamba_inner(p: Mamba2, h: torch.Tensor, cfg: ModelConfig):
    """The input projection split into ``(z, xBC, dt)``.  h: (B, S, D)."""
    d_inner, H, ds, conv_ch = _mamba_dims(cfg)
    proj = h @ p.in_proj
    return torch.split(proj, [d_inner, conv_ch, H], dim=-1)


def mamba2_block(p: Mamba2Block, x: torch.Tensor, cfg: ModelConfig, positions=None):
    """Returns ``(x, (aux, None))``: aux is the reference's float32 zero."""
    ps = p.ssm
    h = unshard_seq(rms_norm(x, ps.norm, cfg.norm_eps))
    y = local_call(_mamba_mix, h @ ps.in_proj, ps.conv_w, ps.conv_bias, ps.dt_bias, ps.A_log,
                   ps.skip_D, ps.out_norm, cfg)
    return unshard_seq(x) + y @ ps.out_proj, (_zero(x), None)


def _mamba_mix(proj, conv_w, conv_bias, dt_bias, A_log, skip_D, out_norm, cfg: ModelConfig):
    """Between Mamba2's projections: the split into ``(z, xBC, dt)``, the
    causal conv, the SSD recurrence, the skip and the gated norm."""
    d_inner, H, ds, conv_ch = _mamba_dims(cfg)
    B, S, _ = proj.shape
    z, xBC, dt = torch.split(proj, [d_inner, conv_ch, H], dim=-1)
    xBC = F.silu(_causal_conv(xBC, conv_w, conv_bias))
    xc, B_, C_ = torch.split(xBC, [d_inner, ds, ds], dim=-1)
    v = xc.reshape(B, S, H, cfg.ssm_head_dim)
    dtp = F.softplus(dt.float() + dt_bias)                               # (B, S, H)
    log_decay = -torch.exp(A_log) * dtp
    # B_/C_ are shared across heads (ngroups = 1): passed 3-D
    y, _ = la.chunked_scalar_decay(C_, B_, v * dtp[..., None].to(v.dtype), log_decay)
    y = y + skip_D.to(v.dtype)[None, None, :, None] * v
    y = y.reshape(B, S, d_inner)
    return rms_norm(y * F.silu(z), out_norm, cfg.norm_eps)


def mamba2_block_decode(p: Mamba2Block, x: torch.Tensor, cfg: ModelConfig, conv_state,
                        ssm_state):
    """x: (B, 1, D); conv_state: (B, width - 1, conv_ch) in the model's
    dtype; ssm_state: (B, H, ssm_state, head_dim) float32.  The conv runs
    in float32 and is cast back after ``silu``, as the reference's.
    Returns ``(x, (conv_state, ssm_state))``, both new tensors.  Under a
    mesh the step runs on each rank's batch rows and its block of the
    state's heads (:func:`_mamba_step`)."""
    ps = p.ssm
    d_inner = _mamba_dims(cfg)[0]
    B = x.shape[0]
    h = rms_norm(x, ps.norm, cfg.norm_eps)
    proj = h @ ps.in_proj
    step = (proj, conv_state, ssm_state, ps.conv_w, ps.conv_bias, ps.dt_bias, ps.A_log,
            ps.skip_D)
    if active()[0] is None:
        y, z, window, ssm_state = _mamba_step(*step, cfg=cfg)
    else:
        from torch.distributed.tensor import Replicate, Shard

        rows = [Shard(0) if q == Shard(0) else Replicate() for q in ssm_state.placements]
        heads = [Shard(1) if q == Shard(1) else r for q, r in zip(ssm_state.placements, rows)]
        y_pl = [Shard(2) if q == Shard(1) else r for q, r in zip(heads, rows)]
        rep = [Replicate()] * len(rows)
        h0 = local_offset(ssm_state)[1]
        y, z, window, ssm_state = shard_call(
            lambda *a: _mamba_step(*a, cfg=cfg, h0=h0),
            [rows, rows, heads, rep, rep, rep, rep, rep], [y_pl, rows, rows, heads], *step)
    y = y.reshape(B, 1, d_inner)
    y = rms_norm(y * F.silu(z), ps.out_norm, cfg.norm_eps)
    return x + y @ ps.out_proj, (window, ssm_state)


def _mamba_step(proj, conv_state, ssm_state, conv_w, conv_bias, dt_bias, A_log, skip_D, *,
                cfg: ModelConfig, h0: int = 0):
    """Mamba2's single step between its projections, for the heads
    ``[h0, h0 + ssm_state.shape[1])`` (all of them on one device).
    Returns ``(y (B, 1, H_l, head_dim), z, new conv window, new state)``."""
    d_inner, H, ds, conv_ch = _mamba_dims(cfg)
    B = proj.shape[0]
    z, xBC, dt = torch.split(proj, [d_inner, conv_ch, H], dim=-1)
    window = torch.cat([conv_state, xBC], dim=1)                        # (B, width, ch)
    conv = torch.einsum("bwc,wc->bc", window.float(), conv_w.float()) + conv_bias.float()
    xBC1 = F.silu(conv).to(proj.dtype)
    xc, B_, C_ = torch.split(xBC1, [d_inner, ds, ds], dim=-1)
    v = xc.reshape(B, H, cfg.ssm_head_dim)
    dtp = F.softplus(dt[:, 0].float() + dt_bias)                         # (B, H)
    log_decay = -torch.exp(A_log) * dtp
    skip = skip_D
    Hl = ssm_state.shape[1]
    if Hl != H:  # this rank's heads
        v, dtp, log_decay, skip = (a[..., h0:h0 + Hl] if a.dim() == 1 else a[:, h0:h0 + Hl]
                                   for a in (v, dtp, log_decay, skip))
    k = B_[:, None, :].expand(B, Hl, ds)
    q = C_[:, None, :].expand(B, Hl, ds)
    y, ssm_state = la.step_scalar_decay(q, k, v * dtp[..., None].to(v.dtype), log_decay,
                                        ssm_state)
    y = y + skip.to(v.dtype)[None, :, None] * v
    return y[:, None], z, window[:, 1:], ssm_state


# ===========================================================================
# RWKV6 block (Finch: a data-dependent decay per channel)
# ===========================================================================

#: the rank of RWKV6's decay LoRA
RWKV_LORA = 64
_RWKV_MU = ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w", "mu_ck", "mu_cr")


def _rwkv_dims(cfg: ModelConfig):
    hd = cfg.ssm_head_dim
    return cfg.d_model // hd, hd


class RWKV6(nn.Module):
    """The RWKV6 layer's parameters: the norms ``norm_t``, ``norm_c`` and
    ``ln_x``; the bonus ``u`` (H, head_dim) and the decay base ``w0``
    (D), float32 in every model dtype; the time mix's ``wr``, ``wk``,
    ``wv``, ``wg``, ``wo`` (D, D) and decay LoRA ``w_lora_a`` (D, 64),
    ``w_lora_b`` (64, D); the channel mix's ``ck`` (D, F), ``cv`` (F, D),
    ``cr`` (D, D); and the token-shift mixes ``mu_*`` (D)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        D, Fd = cfg.d_model, cfg.d_ff
        H, hd = _rwkv_dims(cfg)
        e = lambda *shape, dt=dtype: _param(torch.empty(shape, dtype=dt, device=device))  # noqa: E731
        self.norm_t = e(D)
        self.norm_c = e(D)
        self.ln_x = e(D)
        self.u = e(H, hd, dt=torch.float32)
        self.w0 = e(D, dt=torch.float32)
        for name in ("wr", "wk", "wv", "wg", "wo"):
            setattr(self, name, e(D, D))
        self.w_lora_a = e(D, RWKV_LORA)
        self.w_lora_b = e(RWKV_LORA, D)
        self.ck = e(D, Fd)
        self.cv = e(Fd, D)
        self.cr = e(D, D)
        for name in _RWKV_MU:
            setattr(self, name, e(D))

    @torch.no_grad()
    def reset(self, gen: torch.Generator, cfg: ModelConfig) -> None:
        """The reference's distributions, drawn in the order u, wr, wk,
        wv, wg, wo, w_lora_a, w_lora_b, ck, cv, cr: unit norms, ``u`` a
        float32 normal times 0.1, ``w0 = -2`` (w = exp(-exp(-2)), about
        0.87), scaled-normal projections, ``w_lora_b`` a normal times
        0.01, every ``mu_*`` 0.5."""
        D, Fd = cfg.d_model, cfg.d_ff
        H, hd = _rwkv_dims(cfg)
        dt, dev = self.wr.dtype, self.wr.device
        for name in ("norm_t", "norm_c", "ln_x"):
            getattr(self, name).copy_(init_norm(D, dt, dev))
        self.u.copy_(torch.randn((H, hd), generator=gen, dtype=torch.float32, device=dev) * 0.1)
        self.w0.fill_(-2.0)
        for name in ("wr", "wk", "wv", "wg", "wo"):
            getattr(self, name).copy_(init_dense(gen, D, D, dt, dev))
        self.w_lora_a.copy_(init_dense(gen, D, RWKV_LORA, dt, dev))
        lora_b = torch.randn((RWKV_LORA, D), generator=gen, dtype=torch.float32, device=dev)
        self.w_lora_b.copy_((lora_b * 0.01).to(dt))
        self.ck.copy_(init_dense(gen, D, Fd, dt, dev))
        self.cv.copy_(init_dense(gen, Fd, D, dt, dev))
        self.cr.copy_(init_dense(gen, D, D, dt, dev))
        for name in _RWKV_MU:
            getattr(self, name).fill_(0.5)


class RWKV6Block(nn.Module):
    """One RWKV6 layer: ``rwkv``."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.rwkv = RWKV6(cfg, dtype, device)

    def reset(self, gen: torch.Generator, cfg: ModelConfig) -> None:
        self.rwkv.reset(gen, cfg)


def init_rwkv6_block(gen: torch.Generator, cfg: ModelConfig, dtype, device=None) -> RWKV6Block:
    blk = RWKV6Block(cfg, dtype, device if device is not None else gen.device)
    blk.reset(gen, cfg)
    return blk


def _shift(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """Token shift: the previous token's features.  x: (B, S, D); last:
    (B, D) from the previous segment (zeros at the sequence's start)."""
    return torch.cat([last[:, None, :], x[:, :-1, :]], dim=1)


def _log_decay(pr: RWKV6, mixed_w: torch.Tensor) -> torch.Tensor:
    """``-exp(w0 + lora(x))`` in float32: the LoRA's output is cast to
    float32 before ``w0`` is added, as the reference's."""
    return -torch.exp(pr.w0 + (torch.tanh(mixed_w @ pr.w_lora_a) @ pr.w_lora_b).float())


def _channel_mix(pr: RWKV6, h2: torch.Tensor, h2x: torch.Tensor) -> torch.Tensor:
    kk = h2 + (h2x - h2) * pr.mu_ck
    rr = h2 + (h2x - h2) * pr.mu_cr
    kk = torch.square(F.relu(kk @ pr.ck))
    return torch.sigmoid(rr @ pr.cr) * (kk @ pr.cv)


def rwkv6_block(p: RWKV6Block, x: torch.Tensor, cfg: ModelConfig, positions=None,
                shift_t: Optional[torch.Tensor] = None, shift_c: Optional[torch.Tensor] = None):
    """Returns ``(x, (aux, (shift_t, shift_c)))``: the last position's
    normed inputs to the time and channel mixes."""
    pr = p.rwkv
    B, S, D = x.shape
    H, hd = _rwkv_dims(cfg)
    if shift_t is None:
        shift_t = replicated(torch.zeros((B, D), dtype=x.dtype, device=x.device))
    if shift_c is None:
        shift_c = replicated(torch.zeros((B, D), dtype=x.dtype, device=x.device))

    # time mix
    h = unshard_seq(rms_norm(x, pr.norm_t, cfg.norm_eps))
    hx = _shift(h, shift_t)

    def mixed(mu):
        return h + (hx - h) * mu

    r, k, v = (_split_heads(mixed(mu) @ w, H, hd)
               for mu, w in ((pr.mu_r, pr.wr), (pr.mu_k, pr.wk), (pr.mu_v, pr.wv)))
    g = mixed(pr.mu_g) @ pr.wg
    log_decay = _split_heads(_log_decay(pr, mixed(pr.mu_w)), H, hd)
    y, _ = local_call(la.chunked_vector_decay, r, k, v, log_decay, pr.u)
    y = rms_norm(y.reshape(B, S, D), pr.ln_x, cfg.norm_eps)
    x = unshard_seq(x) + (y * F.silu(g)) @ pr.wo

    # channel mix
    h2 = unshard_seq(rms_norm(x, pr.norm_c, cfg.norm_eps))
    x = unshard_seq(x) + _channel_mix(pr, h2, _shift(h2, shift_c))
    return x, (_zero(x), (h[:, -1, :], h2[:, -1, :]))


def rwkv6_block_decode(p: RWKV6Block, x: torch.Tensor, cfg: ModelConfig, shift_t, shift_c,
                       wkv_state):
    """x: (B, 1, D); shift_t / shift_c: (B, D); wkv_state: (B, H, hd, hd)
    float32.  Returns ``(x, (shift_t, shift_c, wkv_state))``, new
    tensors."""
    pr = p.rwkv
    B, _, D = x.shape
    H, hd = _rwkv_dims(cfg)

    h = rms_norm(x, pr.norm_t, cfg.norm_eps)[:, 0]                     # (B, D)

    def mixed(mu):
        return h + (shift_t - h) * mu

    r, k, v = (_split_heads(mixed(mu) @ w, H, hd)
               for mu, w in ((pr.mu_r, pr.wr), (pr.mu_k, pr.wk), (pr.mu_v, pr.wv)))
    g = mixed(pr.mu_g) @ pr.wg
    log_decay = _split_heads(_log_decay(pr, mixed(pr.mu_w)), H, hd)
    if active()[0] is None:
        y, wkv_state = la.step_vector_decay(r, k, v, log_decay, pr.u, wkv_state)
    else:  # each rank's batch rows and its block of the state's heads
        from torch.distributed.tensor import Replicate, Shard

        rows = [Shard(0) if q == Shard(0) else Replicate() for q in wkv_state.placements]
        heads = [Shard(1) if q == Shard(1) else w for q, w in zip(wkv_state.placements, rows)]
        bonus = [Shard(0) if q == Shard(1) else Replicate() for q in heads]
        y, wkv_state = shard_call(la.step_vector_decay, [heads] * 4 + [bonus, heads],
                                  [heads, heads], r, k, v, log_decay, pr.u, wkv_state)
    y = rms_norm(y.reshape(B, D), pr.ln_x, cfg.norm_eps)
    x = x + ((y * F.silu(g)) @ pr.wo)[:, None, :]

    h2 = rms_norm(x, pr.norm_c, cfg.norm_eps)[:, 0]
    x = x + _channel_mix(pr, h2, shift_c)[:, None, :]
    return x, (h, h2, wkv_state)
