"""Per-layer blocks of the dense family: GQA attention (bias, qk-norm,
sliding window, RoPE) and the gated-MLP residual, full-sequence and
single-token decode.

The port of the dense part of the reference's ``repro.models.blocks``.
Parameters live in :class:`torch.nn.Module` s whose attribute names are
the reference's dict keys (``attn.wq``, ``mlp.w_gate``, ...); the blocks
themselves are plain functions ``block(p, x, ...)`` over those modules,
as the reference's are over dicts.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (
    decode_attention,
    flash_attention,
    gated_mlp,
    init_dense,
    init_norm,
    ring_update,
    rms_norm,
    rope,
)

__all__ = [
    "CACHE_UPDATES",
    "Attention",
    "DenseBlock",
    "MLP",
    "attention",
    "attention_decode",
    "dense_block",
    "dense_block_decode",
    "init_dense_block",
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
        raise NotImplementedError(
            "M-RoPE (the vlm family) is not ported yet: ROADMAP Queue 1")
    return rope(q, k, positions, cfg.rope_theta)


def attention(p: Attention, x: torch.Tensor, cfg: ModelConfig, positions, *, causal=True):
    """Full-sequence attention (training / prefill shapes).  positions:
    (B, S) int.  Returns ``(x + o, (k, v))``."""
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
