"""Per-layer blocks of the attention families: GQA attention (bias,
qk-norm, sliding window, RoPE or M-RoPE), the gated-MLP residual, the
top-k mixture of experts with GShard's grouped capacity dispatch, and
the encoder-decoder cross-attention, full-sequence and single-token
decode.

The port of the attention part of the reference's ``repro.models.blocks``
(the Mamba2 and RWKV6 blocks are not ported yet: ROADMAP Queue 1).
Parameters live in :class:`torch.nn.Module` s whose attribute names are
the reference's dict keys (``attn.wq``, ``mlp.w_gate``, ...); the blocks
themselves are plain functions ``block(p, x, ...)`` over those modules,
as the reference's are over dicts.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
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
    "attention",
    "attention_decode",
    "cross_attention",
    "dense_block",
    "dense_block_decode",
    "encode_kv",
    "init_cross_attention",
    "init_dense_block",
    "init_moe_block",
    "moe_block",
    "moe_block_decode",
    "moe_ffn",
    "moe_route",
    "recording_routes",
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


def _project_qkv(p: Attention, x: torch.Tensor, cfg: ModelConfig):
    B, S, D = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bias_q, k + p.bias_k, v + p.bias_v
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
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
    h = rms_norm(x, p.norm, cfg.norm_eps)
    q, k, v = _project_qkv(p, h, cfg)
    q, k = _apply_rope(q, k, cfg, positions)
    o = flash_attention(q, k, v, causal=causal, window=cfg.sliding_window)
    o = o.reshape(*x.shape[:2], -1) @ p.wo
    return x + o, (k, v)


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
        o = o.reshape(x.shape[0], 1, -1) @ p.wo
        return x + o, (k, v)
    if cfg.cache_update in ("ring", "dus"):
        ring_update(k_cache, k, slot)
        ring_update(v_cache, v, slot)
    elif cfg.cache_update == "onehot":
        onehot = (torch.arange(S, device=x.device) == slot).to(k_cache.dtype)[None, :, None, None]
        k_cache.copy_(k_cache * (1 - onehot) + k.to(k_cache.dtype) * onehot)
        v_cache.copy_(v_cache * (1 - onehot) + v.to(v_cache.dtype) * onehot)
    else:
        raise ValueError(f"unknown cache_update {cfg.cache_update!r}; expected one of "
                         f"{CACHE_UPDATES}")
    o = decode_attention(
        q, k_cache.to(q.dtype), v_cache.to(q.dtype), t,
        window=cfg.sliding_window, kpos=kpos,
    )
    o = o.reshape(x.shape[0], 1, -1) @ p.wo
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
    h = rms_norm(x, p.norm, cfg.norm_eps)
    return x + gated_mlp(p, h, cfg.activation)


def dense_block(p: DenseBlock, x: torch.Tensor, cfg: ModelConfig, positions, *, causal=True):
    """Returns ``(x, (aux, (k, v)))``: aux is the reference's float32 zero."""
    x, kv = attention(p.attn, x, cfg, positions, causal=causal)
    x = _mlp_res(p.mlp, x, cfg)
    return x, (torch.zeros((), dtype=torch.float32, device=x.device), kv)


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
    h = rms_norm(x, p.norm, cfg.norm_eps)
    B, S, D = x.shape
    H, hd = cfg.num_heads, cfg.hd
    q = (h @ p.wq).reshape(B, S, H, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
    k, v = enc_kv
    o = flash_attention(q, k, v, causal=False)
    return x + o.reshape(B, S, -1) @ p.wo


def encode_kv(p: CrossAttention, enc_out: torch.Tensor, cfg: ModelConfig):
    """Cross-attention K/V from the encoder output (once per sequence;
    every decode step reuses them): ``(B, S_enc, KV, hd)`` each."""
    B, S, _ = enc_out.shape
    KV, hd = cfg.num_kv_heads, cfg.hd
    k = (enc_out @ p.wk).reshape(B, S, KV, hd)
    v = (enc_out @ p.wv).reshape(B, S, KV, hd)
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
    ``cap`` and the load-balancing ``aux``."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    gs = min(cfg.moe_group_size, S)
    if S % gs:
        raise ValueError(f"MoE routing needs the sequence ({S}) to be a multiple of the "
                         f"group size min(moe_group_size, S) = {gs}")
    nsb = S // gs
    xg = x.reshape(B, nsb, gs, D)
    cap = max(int(gs * K / E * cfg.moe_capacity_factor), 1)

    logits = torch.einsum("bnsd,de->bnse", xg.float(), p.router.float())
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
    return {"xg": xg, "gate_idx": gate_idx, "keep": keep, "slot": slot, "dispatch": dispatch,
            "combine": combine, "cap": cap, "aux": aux}


def moe_ffn(p: MoE, x: torch.Tensor, cfg: ModelConfig):
    """The experts on :func:`moe_route`'s dispatch: each expert's gated
    MLP over its ``cap`` slots of every group, combined back with the
    gate weights (dropped tokens get zero).  The dispatch product is
    float32, the expert products in the model's dtype.  Returns ``(y
    (B, S, D), aux)``."""
    B, S, D = x.shape
    r = moe_route(p, x, cfg)
    xin = torch.einsum("bnsec,bnsd->ebncd", r["dispatch"], r["xg"].float()).to(x.dtype)
    act = _ACTIVATIONS[cfg.activation]
    h = act(torch.einsum("ebncd,edf->ebncf", xin, p.w_gate)) * torch.einsum(
        "ebncd,edf->ebncf", xin, p.w_in)
    out = torch.einsum("ebncf,efd->ebncd", h, p.w_out)
    y = torch.einsum("bnsec,ebncd->bnsd", r["combine"].to(x.dtype), out)
    return y.reshape(B, S, D), r["aux"]


def moe_block(p: MoEBlock, x: torch.Tensor, cfg: ModelConfig, positions, *, causal=True):
    """Returns ``(x, (aux, (k, v)))``."""
    x, kv = attention(p.attn, x, cfg, positions, causal=causal)
    h = rms_norm(x, p.moe.norm, cfg.norm_eps)
    y, aux = moe_ffn(p.moe, h, cfg)
    return x + y, (aux, kv)


def moe_block_decode(p: MoEBlock, x: torch.Tensor, cfg: ModelConfig, k_cache, v_cache, t,
                     positions, kpos=None):
    """One token: groups of one, so ``cap = 1`` and nothing drops."""
    x, (k_cache, v_cache) = attention_decode(
        p.attn, x, cfg, k_cache, v_cache, t, positions, kpos
    )
    h = rms_norm(x, p.moe.norm, cfg.norm_eps)
    y, _ = moe_ffn(p.moe, h, cfg)
    return x + y, (k_cache, v_cache)
