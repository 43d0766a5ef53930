"""Model assembly for every family (``dense``, ``vlm``, ``moe``,
``encdec``, and the recurrent ``ssm``, ``rwkv`` and ``hybrid``):
embedding, a loop over the layers, and the head, with ``forward`` (full
sequence), ``prefill`` (full sequence to a serving cache and the last
position's logits; the attention families only, as in the reference)
and ``decode_step`` (one token against the family's cache), plus the
encoder-decoder's ``encode`` and ``make_cross_cache``.

The port of the reference's ``repro.models.model``.  The reference
stacks the layers on a leading L axis and scans them; here each layer is
a module of its own, run in a Python loop, and the decode cache keeps
the reference's stacked layouts (``(L, B, S, KV, hd)`` K/V; the
recurrent families' ``conv``/``ssm``, ``shift_t``/``shift_c``/``wkv``).
:func:`params_from_reference` and :func:`params_to_reference` are the one
place the reference's parameter tree is mapped onto the port's
parameters and back.  Training (:meth:`Model.trainable`) turns gradients
on; with ``cfg.remat`` each layer then runs under activation
checkpointing, as the reference wraps its scan body in
``jax.checkpoint`` (the hybrid checkpoints a group: ``attn_every``
Mamba2 layers and the shared block).  Serving builds the model with
gradients off.

The ``vlm`` family prepends the frontend's patch embeddings and rotates
by M-RoPE; ``moe`` swaps the gated MLP for GShard-dispatched experts;
``encdec`` adds a bidirectional encoder stack and a cross-attention per
decoder layer.  ``ssm`` stacks Mamba2 layers, ``rwkv`` RWKV6 layers, and
``hybrid`` (Zamba2) Mamba2 layers with one ``shared`` attention block,
not stacked, applied after every ``attn_every`` of them.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (
    bind_rules,
    constrain,
    embedding_lookup,
    replicated,
    unshard_seq,
)
from repro_torch.models import blocks as B
from repro_torch.models.layers import init_dense, init_norm, ring_update_stacked, rms_norm

__all__ = ["PORTED_FAMILIES", "Model", "build_model", "params_from_reference",
           "params_to_reference", "reference_order"]

#: the families whose blocks are ported
PORTED_FAMILIES = ("dense", "vlm", "moe", "encdec", "ssm", "rwkv", "hybrid")

#: family -> (layer module, full-sequence block, decode block)
_BLOCKS = {
    "dense": (B.DenseBlock, B.dense_block, B.dense_block_decode),
    "vlm": (B.DenseBlock, B.dense_block, B.dense_block_decode),
    "encdec": (B.DenseBlock, B.dense_block, B.dense_block_decode),
    "moe": (B.MoEBlock, B.moe_block, B.moe_block_decode),
    "ssm": (B.Mamba2Block, B.mamba2_block, B.mamba2_block_decode),
    "rwkv": (B.RWKV6Block, B.rwkv6_block, B.rwkv6_block_decode),
    "hybrid": (B.Mamba2Block, B.mamba2_block, B.mamba2_block_decode),
}

#: the families whose layers take the attention blocks' ``causal`` flag
_ATTENTION = ("dense", "vlm", "moe", "encdec")

#: the reference's subtrees whose leaves are stacked on a leading layer axis
_STACKS = ("layers", "encoder.layers", "xattn")

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_KV_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "int8": torch.int8}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _kv_dtype(cfg: ModelConfig) -> torch.dtype:
    return _KV_DTYPES[cfg.kv_cache_dtype]


def _stack_len(cfg: ModelConfig, stack: str) -> int:
    return cfg.encoder_layers if stack == "encoder.layers" else cfg.num_layers


class Embed(nn.Module):
    """The token embedding table ``vocab``: (V, D)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.vocab = nn.Parameter(
            torch.empty((cfg.vocab_size, cfg.d_model), dtype=dtype, device=device),
            requires_grad=False)


class Encoder(nn.Module):
    """The encoder-decoder's encoder: ``encoder_layers`` dense layers run
    without a causal mask, and its ``final_norm``."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.layers = nn.ModuleList(B.DenseBlock(cfg, dtype, device)
                                    for _ in range(cfg.encoder_layers))
        self.final_norm = nn.Parameter(torch.empty((cfg.d_model,), dtype=dtype, device=device),
                                       requires_grad=False)


class Model(nn.Module):
    """A language model of any family on one device.  Built with empty
    parameters: :meth:`init` draws them from a seed, ``load_state_dict``
    takes :func:`params_from_reference`'s."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        if cfg.family not in PORTED_FAMILIES:
            raise ValueError(f"unknown family {cfg.family!r}; expected one of {PORTED_FAMILIES}")
        if cfg.family == "hybrid" and (cfg.attn_every < 1 or cfg.num_layers % cfg.attn_every):
            raise ValueError(
                f"a hybrid applies its shared block after every attn_every Mamba2 layers, so "
                f"num_layers ({cfg.num_layers}) must be a positive multiple of attn_every "
                f"({cfg.attn_every})")
        self.cfg = cfg
        # the meta device builds the shapes alone (sharding plans at full width)
        meta = torch.device(device).type == "meta"
        dev = torch.device("meta") if meta else resolve_device(device)
        dt = _dtype(cfg)
        layer_cls, self._block, self._block_decode = _BLOCKS[cfg.family]
        # the embedding scale rounded to the table's dtype first, as the
        # reference casts it (29.875 in bf16 at D = 896); a Python float,
        # so the multiply copies nothing to the device
        self._embed_scale = torch.tensor(math.sqrt(cfg.d_model), dtype=dt).item()
        self.embed = Embed(cfg, dt, dev)
        self.layers = nn.ModuleList(layer_cls(cfg, dt, dev) for _ in range(cfg.num_layers))
        self.final_norm = nn.Parameter(torch.empty((cfg.d_model,), dtype=dt, device=dev),
                                       requires_grad=False)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                torch.empty((cfg.d_model, cfg.vocab_size), dtype=dt, device=dev),
                requires_grad=False)
        if cfg.family == "encdec":
            self.encoder = Encoder(cfg, dt, dev)
            self.xattn = nn.ModuleList(B.CrossAttention(cfg, dt, dev)
                                       for _ in range(cfg.num_layers))
        if cfg.family == "hybrid":
            self.shared = B.DenseBlock(cfg, dt, dev)

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    def trainable(self) -> Dict[str, nn.Parameter]:
        """Turn gradients on and return the parameters by name in the
        reference's tree order (:func:`reference_order`): the ``params``
        the training step takes and updates in place."""
        self.requires_grad_(True)
        named = dict(self.named_parameters())
        return {name: named[name] for name in reference_order(named)}

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------
    @torch.no_grad()
    def init(self, seed: int = 0) -> "Model":
        """Draw every parameter from ``torch.Generator(device).manual_seed(seed)``
        on the model's device, with the reference's distributions (scaled
        normal projections and experts, a float32 router, unit norms, zero
        biases; the recurrent blocks' own, :class:`~repro_torch.models.blocks.Mamba2`
        and :class:`~repro_torch.models.blocks.RWKV6`) in the order embed,
        layers, final norm, head, then for ``encdec`` the encoder's layers
        (its final norm is ones) and the cross-attentions, for ``hybrid``
        the shared block.  Returns ``self``."""
        cfg, dt, dev = self.cfg, self.final_norm.dtype, self.device
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        self.embed.vocab.copy_(init_dense(gen, cfg.vocab_size, cfg.d_model, dt, dev))
        for layer in self.layers:
            layer.reset(gen, cfg)
        self.final_norm.copy_(init_norm(cfg.d_model, dt, dev))
        if not cfg.tie_embeddings:
            self.lm_head.copy_(init_dense(gen, cfg.d_model, cfg.vocab_size, dt, dev))
        if cfg.family == "encdec":
            for layer in self.encoder.layers:
                layer.reset(gen, cfg)
            self.encoder.final_norm.copy_(init_norm(cfg.d_model, dt, dev))
            for xa in self.xattn:
                xa.reset(gen, cfg)
        if cfg.family == "hybrid":
            self.shared.reset(gen, cfg)
        return self

    # ------------------------------------------------------------------
    # embedding / head
    # ------------------------------------------------------------------
    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return embedding_lookup(self.embed.vocab, tokens) * self._embed_scale

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        """Float32 logits (B, S, V)."""
        x = unshard_seq(rms_norm(x, self.final_norm, self.cfg.norm_eps))
        w = self.embed.vocab.T if self.cfg.tie_embeddings else self.lm_head
        logits = torch.matmul(x.float(), w.float())  # preferred_element_type=float32
        return constrain(logits, "batch", None, "vocab")

    def _with_patches(self, x: torch.Tensor, patch_embeds: torch.Tensor) -> torch.Tensor:
        """The vision patches prepended to the token embeddings, cut back
        to the tokens' length S (so at ``num_patches >= S`` no token is
        left, as in the reference)."""
        S = x.shape[1]
        patches = patch_embeds.to(self.device, x.dtype)
        return torch.cat([patches, x], dim=1)[:, :S]

    def _positions(self, positions: Optional[torch.Tensor], Bsz: int, S: int) -> torch.Tensor:
        """``arange(S)`` per row by default; a 2-D ``positions`` is
        broadcast to M-RoPE's three streams."""
        if positions is None:
            positions = replicated(torch.arange(S, device=self.device).expand(Bsz, S))
        positions = positions.to(self.device)
        if self.cfg.mrope and positions.dim() == 2:
            positions = positions.expand(3, *positions.shape)
        return positions

    # ------------------------------------------------------------------
    # layer stacks (train / prefill direction)
    # ------------------------------------------------------------------
    def _run_stack(self, layers, x: torch.Tensor, positions, *, causal=True,
                   collect_kv=False):
        """Run ``layers`` over ``x``; returns ``(x, aux, kvs)``, ``kvs`` the
        per-layer ``(k, v)`` under ``collect_kv`` (else None)."""
        cfg = self.cfg  # the encoder's layers are dense, as encdec's decoder's
        remat = cfg.remat and torch.is_grad_enabled()
        aux = B._zero(x)
        kvs = [] if collect_kv else None
        block = (functools.partial(self._block, causal=causal) if cfg.family in _ATTENTION
                 else self._block)
        for layer in layers:
            def body(h, layer=layer):
                h, (a, kv) = block(layer, h, cfg, positions)
                return constrain(h, "batch", "seq", None), a, kv

            if remat:  # keep each layer's input; recompute the rest in backward
                x, a, kv = checkpoint(bind_rules(body), x, use_reentrant=False,
                                      preserve_rng_state=False)
            else:
                x, a, kv = body(x)
            aux = aux + a
            if collect_kv:
                kvs.append(kv)
        return x, aux, kvs

    def _run_hybrid(self, x, positions):
        """Zamba2: groups of ``attn_every`` Mamba2 layers, each followed by
        the one shared attention block; under remat a group is one
        checkpoint, as the reference checkpoints its group body."""
        cfg = self.cfg
        k = cfg.attn_every
        remat = cfg.remat and torch.is_grad_enabled()
        aux = B._zero(x)
        for g in range(cfg.num_layers // k):
            def group(h, group_layers=self.layers[g * k:(g + 1) * k]):
                a = B._zero(h)
                for layer in group_layers:
                    h, (al, _) = B.mamba2_block(layer, h, cfg)
                    a = a + al
                h, (al, _) = B.dense_block(self.shared, h, cfg, positions)
                return constrain(h, "batch", "seq", None), a + al

            if remat:
                x, a = checkpoint(bind_rules(group), x, use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                x, a = group(x)
            aux = aux + a
        return x, aux

    def _run_encdec_decoder(self, x, positions, enc):
        cfg = self.cfg
        remat = cfg.remat and torch.is_grad_enabled()
        aux = B._zero(x)
        for layer, xa in zip(self.layers, self.xattn):
            def body(h, layer=layer, xa=xa):
                h, (a, _) = B.dense_block(layer, h, cfg, positions)
                h = B.cross_attention(xa, h, cfg, B.encode_kv(xa, enc, cfg))
                return constrain(h, "batch", "seq", None), a

            if remat:
                x, a = checkpoint(bind_rules(body), x, use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                x, a = body(x)
            aux = aux + a
        return x, aux

    # ------------------------------------------------------------------
    # forward (training shapes; returns full logits)
    # ------------------------------------------------------------------
    def forward(self, tokens: torch.Tensor, positions: Optional[torch.Tensor] = None, *,
                patch_embeds: Optional[torch.Tensor] = None,
                enc_embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``tokens``: (B, S); ``positions``: (B, S) or, under M-RoPE,
        (3, B, S), ``arange(S)`` by default; ``patch_embeds`` (vlm: B,
        num_patches, D) and ``enc_embeds`` (encdec: B, S_enc, D) are the
        frontend stubs' embeddings.  Returns ``(logits (B, S, V) float32,
        aux)``, ``aux`` the MoE load-balancing loss summed over the layers
        (0 for the other families)."""
        cfg = self.cfg
        tokens = tokens.to(self.device)
        Bsz, S = tokens.shape
        x = self._embed(tokens)
        if cfg.family == "vlm":
            if patch_embeds is None:
                raise ValueError("the vlm family's forward needs patch_embeds")
            x = self._with_patches(x, patch_embeds)
        x = constrain(x, "batch", "seq", None)
        positions = self._positions(positions, Bsz, S)
        if cfg.family == "encdec":
            if enc_embeds is None:
                raise ValueError("the encdec family's forward needs enc_embeds")
            x, aux = self._run_encdec_decoder(x, positions, self.encode(enc_embeds))
        elif cfg.family == "hybrid":
            x, aux = self._run_hybrid(x, positions)
        else:
            x, aux, _ = self._run_stack(self.layers, x, positions)
        return self._head(x), aux

    # ------------------------------------------------------------------
    # prefill: forward + the serving cache and last-position logits
    # ------------------------------------------------------------------
    def prefill(self, tokens: torch.Tensor, *,
                patch_embeds: Optional[torch.Tensor] = None):
        """The full sequence once, at positions ``arange(S)`` (as the
        reference, which ignores a batch's ``positions`` here), with the
        patches prepended for vlm when given.  Returns ``(logits (B, V)
        float32 of the last position, {"k", "v"})``: every layer's roped
        K and V, ``(L, B, S, KV, hd)`` in the KV dtype (no ``kpos``, as in
        the reference).  The encoder-decoder has no prefill (the
        reference raises)."""
        cfg = self.cfg
        if cfg.family not in ("dense", "vlm", "moe"):
            raise NotImplementedError(
                "prefill caches for recurrent/encdec families are built by their decode "
                "drivers")
        tokens = tokens.to(self.device)
        Bsz, S = tokens.shape
        x = self._embed(tokens)
        if cfg.family == "vlm" and patch_embeds is not None:
            x = self._with_patches(x, patch_embeds)
        x = constrain(x, "batch", "seq", None)
        positions = self._positions(None, Bsz, S)
        x, _, kvs = self._run_stack(self.layers, x, positions, collect_kv=True)
        kvdt = _kv_dtype(cfg)
        cache = {key: constrain(torch.stack([kv[i] for kv in kvs]).to(kvdt),
                                None, "batch", "kv_seq", None, None)
                 for i, key in enumerate(("k", "v"))}
        return self._head(x[:, -1:, :])[:, 0], cache

    # ------------------------------------------------------------------
    # decode: one token, cache carried
    # ------------------------------------------------------------------
    def init_cache(self, batch_size: int, max_len: int,
                   enc_len: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """The decode cache, by family (the reference's layouts).  The
        attention families: ``k``/``v`` ``(L, B, S, KV, hd)`` in the KV
        dtype with ``S = min(max_len, sliding_window)``, and ``kpos``
        ``(S,)``, the absolute position each slot holds (-1: empty); for
        encdec also the cross-attention ``xk``/``xv`` ``(L, B, enc_len or
        max_len, KV, hd)`` in the model's dtype, zero until
        :meth:`make_cross_cache`'s are put there.  ``ssm``: the Mamba2
        layers' ``conv`` ``(L, B, width - 1, conv_ch)`` in the model's
        dtype and ``ssm`` ``(L, B, H, ssm_state, head_dim)`` float32;
        ``hybrid`` adds the shared block's ``shared_k``/``shared_v``
        ``(L / attn_every, B, S, KV, hd)`` and ``kpos``.  ``rwkv``:
        ``shift_t``/``shift_c`` ``(L, B, D)`` in the model's dtype and
        ``wkv`` ``(L, B, H, head_dim, head_dim)`` float32.  All zeros."""
        cfg = self.cfg
        L, KV, hd = cfg.num_layers, cfg.num_kv_heads, cfg.hd
        S = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
        kvdt, dt, dev = _kv_dtype(cfg), _dtype(cfg), self.device
        zeros = functools.partial(torch.zeros, device=dev)
        if cfg.family == "ssm":
            return self._mamba_cache(L, batch_size)
        if cfg.family == "rwkv":
            H, hd2 = cfg.d_model // cfg.ssm_head_dim, cfg.ssm_head_dim
            return {"shift_t": zeros((L, batch_size, cfg.d_model), dtype=dt),
                    "shift_c": zeros((L, batch_size, cfg.d_model), dtype=dt),
                    "wkv": zeros((L, batch_size, H, hd2, hd2), dtype=torch.float32)}
        if cfg.family == "hybrid":
            groups = L // cfg.attn_every
            cache = self._mamba_cache(L, batch_size)
            cache["shared_k"] = zeros((groups, batch_size, S, KV, hd), dtype=kvdt)
            cache["shared_v"] = zeros((groups, batch_size, S, KV, hd), dtype=kvdt)
            cache["kpos"] = torch.full((S,), -1, dtype=torch.int32, device=dev)
            return cache
        cache = {
            "k": zeros((L, batch_size, S, KV, hd), dtype=kvdt),
            "v": zeros((L, batch_size, S, KV, hd), dtype=kvdt),
            "kpos": torch.full((S,), -1, dtype=torch.int32, device=dev),
        }
        if cfg.family == "encdec":
            se = enc_len or max_len
            for key in ("xk", "xv"):
                cache[key] = zeros((L, batch_size, se, KV, hd), dtype=dt)
        return cache

    def _mamba_cache(self, L: int, batch_size: int) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        d_inner, H, ds, conv_ch = B._mamba_dims(cfg)
        return {
            "conv": torch.zeros((L, batch_size, cfg.ssm_conv_width - 1, conv_ch),
                                dtype=_dtype(cfg), device=self.device),
            "ssm": torch.zeros((L, batch_size, H, ds, cfg.ssm_head_dim), dtype=torch.float32,
                               device=self.device),
        }

    def decode_step(self, cache: Dict[str, torch.Tensor], tokens: torch.Tensor, t: int):
        """``tokens``: (B,) the current input token of each row; ``t``:
        the position (one for the whole batch, as in the reference).
        Returns ``(logits (B, V) float32, cache)``: the cache's tensors are
        written in place (K/V one row each under ``dus``/``ring``/
        ``deferred``; the recurrent states whole) and ``kpos`` is
        replaced."""
        cfg = self.cfg
        t = int(t)
        tokens = tokens.to(self.device)
        Bsz = tokens.shape[0]
        x = self._embed(tokens[:, None])
        if cfg.family in ("ssm", "rwkv"):
            return self._decode_recurrent(cache, x)
        pos = self._positions(
            replicated(torch.full((Bsz, 1), t, dtype=torch.long, device=self.device)), Bsz, 1)
        kc_all = cache["shared_k" if cfg.family == "hybrid" else "k"]
        S = kc_all.shape[2]
        slot = t % S
        at_slot = replicated(torch.arange(S, device=self.device) == slot)
        if cfg.family == "hybrid":
            return self._decode_hybrid(cache, x, t, pos, at_slot)
        if cfg.family == "encdec":
            return self._decode_encdec(cache, x, t, pos, at_slot)
        vc_all = cache["v"]
        if cfg.cache_update == "deferred":
            # mask the stale slot row during attention; the new rows are
            # attended explicitly and written once for all layers after
            kpos_mask = torch.where(at_slot, -1, cache["kpos"])
            k_rows, v_rows = [], []
            for layer, kc, vc in zip(self.layers, kc_all, vc_all):
                x, (k_new, v_new) = self._block_decode(layer, x, cfg, kc, vc, t, pos,
                                                       kpos_mask)
                k_rows.append(k_new)
                v_rows.append(v_new)
            kpos = torch.where(at_slot, t, cache["kpos"]).to(torch.int32)
            ring_update_stacked(kc_all, torch.stack(k_rows), slot)
            ring_update_stacked(vc_all, torch.stack(v_rows), slot)
        else:
            kpos = torch.where(at_slot, t, cache["kpos"]).to(torch.int32)
            for layer, kc, vc in zip(self.layers, kc_all, vc_all):
                x, _ = self._block_decode(layer, x, cfg, kc, vc, t, pos, kpos)
        cache = {"k": kc_all, "v": vc_all, "kpos": kpos}
        return self._head(x)[:, 0], cache

    def _decode_recurrent(self, cache, x):
        """``ssm`` and ``rwkv``: each layer's single-step update, its state
        written back into the cache's slice."""
        cfg = self.cfg
        keys = ("conv", "ssm") if cfg.family == "ssm" else ("shift_t", "shift_c", "wkv")
        for i, layer in enumerate(self.layers):
            x, new = self._block_decode(layer, x, cfg, *(cache[key][i] for key in keys))
            for key, val in zip(keys, new):
                cache[key][i].copy_(val)
        return self._head(x)[:, 0], {key: cache[key] for key in keys}

    def _decode_hybrid(self, cache, x, t, pos, at_slot):
        """Zamba2: each group's ``attn_every`` Mamba2 steps, then the shared
        block against the group's own K/V (``shared_k``/``shared_v``
        ``[g]``), all written in place.  ``cache_update="deferred"``
        raises: the shared block's decode would return new rows, which the
        reference then stacks as the cache."""
        cfg = self.cfg
        if cfg.cache_update == "deferred":
            raise ValueError("the hybrid decode step writes the shared block's cache per group; "
                             "cache_update='deferred' is not supported for it")
        k = cfg.attn_every
        kpos = torch.where(at_slot, t, cache["kpos"]).to(torch.int32)
        conv, ssm = cache["conv"], cache["ssm"]
        for g, (kc, vc) in enumerate(zip(cache["shared_k"], cache["shared_v"])):
            for i in range(g * k, (g + 1) * k):
                x, (c, s) = B.mamba2_block_decode(self.layers[i], x, cfg, conv[i], ssm[i])
                conv[i].copy_(c)
                ssm[i].copy_(s)
            x, _ = B.dense_block_decode(self.shared, x, cfg, kc, vc, t, pos, kpos)
        cache = {"conv": conv, "ssm": ssm, "shared_k": cache["shared_k"],
                 "shared_v": cache["shared_v"], "kpos": kpos}
        return self._head(x)[:, 0], cache

    def _decode_encdec(self, cache, x, t, pos, at_slot):
        cfg = self.cfg
        if cfg.cache_update == "deferred":
            raise ValueError("the encdec decode step writes its cache per layer; "
                             "cache_update='deferred' is not supported for it")
        kpos = torch.where(at_slot, t, cache["kpos"]).to(torch.int32)
        for layer, xa, kc, vc, xk, xv in zip(self.layers, self.xattn, cache["k"], cache["v"],
                                             cache["xk"], cache["xv"]):
            x, _ = B.dense_block_decode(layer, x, cfg, kc, vc, t, pos, kpos)
            x = B.cross_attention(xa, x, cfg, (xk, xv))
        cache = {"k": cache["k"], "v": cache["v"], "kpos": kpos, "xk": cache["xk"],
                 "xv": cache["xv"]}
        return self._head(x)[:, 0], cache

    # ------------------------------------------------------------------
    # encoder-decoder serving helpers
    # ------------------------------------------------------------------
    def encode(self, enc_embeds: torch.Tensor) -> torch.Tensor:
        """Run the encoder once over the frontend stub's embeddings
        ``(B, S_enc, D)`` (cast to the model's dtype), without a causal
        mask, then its final norm."""
        cfg = self.cfg
        enc = constrain(enc_embeds.to(self.device, _dtype(cfg)), "batch", "seq", None)
        Bsz, Se = enc.shape[:2]
        pos = replicated(torch.arange(Se, device=self.device).expand(Bsz, Se))
        enc, _, _ = self._run_stack(self.encoder.layers, enc, pos, causal=False)
        return rms_norm(enc, self.encoder.final_norm, cfg.norm_eps)

    def make_cross_cache(self, enc_out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every decoder layer's cross-attention K/V from the encoder's
        output, stacked: a ``(L, B, S_enc, KV, hd)`` pair (the cache's
        ``xk``/``xv``, reused every decode step)."""
        ks, vs = zip(*(B.encode_kv(xa, enc_out, self.cfg) for xa in self.xattn))
        return torch.stack(ks), torch.stack(vs)


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    """An uninitialized :class:`Model` on ``device`` (the card unless
    ``device="cpu"``; ``"meta"`` for the shapes alone)."""
    return Model(cfg, device=device)


def _to_torch(a: Any) -> torch.Tensor:
    """A reference array (jax or numpy, bf16 included, or a tensor) as a
    CPU tensor, bit for bit."""
    if isinstance(a, torch.Tensor):
        # a DTensor stays where its shards are (a checkpoint restored onto a mesh)
        return a.detach() if _is_dtensor(a) else a.detach().cpu()
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def _is_dtensor(t: torch.Tensor) -> bool:
    return hasattr(t, "device_mesh")


def params_from_reference(cfg: ModelConfig, params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The reference's parameter tree (nested dicts of arrays; ``layers``
    (``attn``/``mlp``/``moe``, ``ssm`` or ``rwkv``) and ``xattn`` stacked
    on a leading ``num_layers`` axis, ``encoder.layers`` on
    ``encoder_layers``; the hybrid's ``shared`` block not stacked) as the
    port's parameters: a dict of CPU tensors keyed by :class:`Model`
    parameter names, for ``Model.load_state_dict``.  Values are copied bit
    for bit, each in its own dtype (the MoE router, Mamba2's ``A_log``,
    ``dt_bias``, ``skip_D`` and RWKV6's ``u``, ``w0`` stay float32)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping[str, Any], path: str, stack: Optional[str]) -> None:
        for key, val in tree.items():
            name = f"{path}.{key}" if path else key
            if stack is None and name in _STACKS:
                walk(val, name, name)
            elif isinstance(val, Mapping):
                walk(val, name, stack)
            elif stack is None:
                out[name] = _to_torch(val)
            else:
                stacked, n = _to_torch(val), _stack_len(cfg, stack)
                if stacked.shape[0] != n:
                    raise ValueError(f"{name}: leading axis {stacked.shape[0]}, want {n} layers")
                rest = name[len(stack) + 1:]
                for layer in range(n):
                    out[f"{stack}.{layer}.{rest}"] = stacked[layer].clone()

    walk(params, "", None)
    return out


def _split_name(name: str) -> Tuple[str, Optional[str], int]:
    """A port parameter name as ``(reference key, stack, layer)``: a
    stacked subtree's ``<stack>.<i>.<rest>`` is the reference leaf
    ``<stack>.<rest>`` at index ``i``; any other name is its own key
    (no stack, layer 0)."""
    for stack in _STACKS:
        head = stack + "."
        if name.startswith(head):
            idx, _, rest = name[len(head):].partition(".")
            if idx.isdigit() and rest:
                return f"{stack}.{rest}", stack, int(idx)
    return name, None, 0


def reference_order(names: Iterable[str]) -> List[str]:
    """``names`` in the order ``jax.tree.leaves`` visits the reference's
    stacked tree (dict keys sorted at every level), each stacked leaf's
    layers in turn: the byte order of the reference's flattened tree."""
    def key(name):
        ref, _, layer = _split_name(name)
        return tuple(ref.split(".")), layer

    return sorted(names, key=key)


def params_to_reference(cfg: ModelConfig, state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`params_from_reference`: tensors keyed by
    :class:`Model` parameter names (parameters, or anything shaped like
    them, such as AdamW moments) as the reference's nested tree, each
    stacked subtree's layers on a leading axis.  Detached tensors on the
    inputs' device."""
    flat: Dict[str, Any] = {}
    for name, t in state_dict.items():
        ref, stack, layer = _split_name(name)
        if stack is not None:
            flat.setdefault(ref, [None] * _stack_len(cfg, stack))[layer] = t.detach()
        else:
            flat[ref] = t.detach()
    tree: Dict[str, Any] = {}
    for ref, val in flat.items():
        if isinstance(val, list):
            missing = [i for i, t in enumerate(val) if t is None]
            if missing:
                raise ValueError(f"{ref}: no tensor for layers {missing}")
            val = torch.stack(val)
        *path, leaf = ref.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = val
    return tree
