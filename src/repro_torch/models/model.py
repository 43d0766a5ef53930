"""Model assembly for the dense family: embedding, a loop over the layers,
and the head, with ``forward`` (full sequence) and ``decode_step`` (one
token against a KV cache).

The port of the dense part of the reference's ``repro.models.model``.
The reference stacks the layers on a leading L axis and scans them; here
each layer is a module of its own, run in a Python loop, and the decode
cache keeps the reference's stacked ``(L, B, S, KV, hd)`` layout.
:func:`params_from_reference` and :func:`params_to_reference` are the one
place the reference's parameter tree is mapped onto the port's
parameters and back.  Training (:meth:`Model.trainable`) turns gradients
on; with ``cfg.remat`` each layer then runs under activation
checkpointing, as the reference wraps its scan body in
``jax.checkpoint``.  Serving builds the model with gradients off.

Other families (``moe``, ``ssm``, ``rwkv``, ``hybrid``, ``encdec``,
``vlm``) and ``prefill`` are not ported yet (ROADMAP Queue 1).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models.layers import init_dense, init_norm, ring_update_stacked, rms_norm

__all__ = ["PORTED_FAMILIES", "Model", "build_model", "params_from_reference",
           "params_to_reference", "reference_order"]

#: the families whose blocks are ported
PORTED_FAMILIES = ("dense",)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_KV_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "int8": torch.int8}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _kv_dtype(cfg: ModelConfig) -> torch.dtype:
    return _KV_DTYPES[cfg.kv_cache_dtype]


class Embed(nn.Module):
    """The token embedding table ``vocab``: (V, D)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.vocab = nn.Parameter(
            torch.empty((cfg.vocab_size, cfg.d_model), dtype=dtype, device=device),
            requires_grad=False)


class Model(nn.Module):
    """A dense-family language model on one device.  Built with empty
    parameters: :meth:`init` draws them from a seed, ``load_state_dict``
    takes :func:`params_from_reference`'s."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        if cfg.family not in PORTED_FAMILIES:
            raise NotImplementedError(
                f"the {cfg.family!r} family ({cfg.name}) is not ported yet: ROADMAP Queue 1 "
                f"lists it; ported: {PORTED_FAMILIES}")
        self.cfg = cfg
        dev = resolve_device(device)
        dt = _dtype(cfg)
        # the embedding scale rounded to the table's dtype first, as the
        # reference casts it (29.875 in bf16 at D = 896); a Python float,
        # so the multiply copies nothing to the device
        self._embed_scale = torch.tensor(math.sqrt(cfg.d_model), dtype=dt).item()
        self.embed = Embed(cfg, dt, dev)
        self.layers = nn.ModuleList(B.DenseBlock(cfg, dt, dev) for _ in range(cfg.num_layers))
        self.final_norm = nn.Parameter(torch.empty((cfg.d_model,), dtype=dt, device=dev),
                                       requires_grad=False)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                torch.empty((cfg.d_model, cfg.vocab_size), dtype=dt, device=dev),
                requires_grad=False)

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
        normal projections, unit norms, zero biases) in the order embed,
        layers, final norm, head.  Returns ``self``."""
        cfg, dt, dev = self.cfg, self.final_norm.dtype, self.device
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        self.embed.vocab.copy_(init_dense(gen, cfg.vocab_size, cfg.d_model, dt, dev))
        for layer in self.layers:
            layer.reset(gen, cfg)
        self.final_norm.copy_(init_norm(cfg.d_model, dt, dev))
        if not cfg.tie_embeddings:
            self.lm_head.copy_(init_dense(gen, cfg.d_model, cfg.vocab_size, dt, dev))
        return self

    # ------------------------------------------------------------------
    # embedding / head
    # ------------------------------------------------------------------
    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed.vocab[tokens.long()] * self._embed_scale

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        """Float32 logits (B, S, V)."""
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        w = self.embed.vocab.T if self.cfg.tie_embeddings else self.lm_head
        return torch.matmul(x.float(), w.float())  # preferred_element_type=float32

    # ------------------------------------------------------------------
    # layer stack (train / prefill direction)
    # ------------------------------------------------------------------
    def _run_stack(self, x: torch.Tensor, positions, *, causal=True):
        cfg = self.cfg
        remat = cfg.remat and torch.is_grad_enabled()
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for layer in self.layers:
            def body(h, layer=layer):
                h, (a, _) = B.dense_block(layer, h, cfg, positions, causal=causal)
                return h, a

            if remat:  # keep each layer's input; recompute the rest in backward
                x, a = checkpoint(body, x, use_reentrant=False, preserve_rng_state=False)
            else:
                x, a = body(x)
            aux = aux + a
        return x, aux

    # ------------------------------------------------------------------
    # forward (training shapes; returns full logits)
    # ------------------------------------------------------------------
    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """``tokens``: (B, S); ``positions``: (B, S), ``arange(S)`` by
        default.  Returns ``(logits (B, S, V) float32, aux)``."""
        tokens = tokens.to(self.device)
        Bsz, S = tokens.shape
        x = self._embed(tokens)
        if positions is None:
            positions = torch.arange(S, device=self.device).expand(Bsz, S)
        x, aux = self._run_stack(x, positions.to(self.device))
        return self._head(x), aux

    # ------------------------------------------------------------------
    # decode: one token, cache carried
    # ------------------------------------------------------------------
    def init_cache(self, batch_size: int, max_len: int) -> Dict[str, torch.Tensor]:
        """The decode cache: ``k``/``v`` ``(L, B, S, KV, hd)`` in the KV
        dtype with ``S = min(max_len, sliding_window)``, and ``kpos``
        ``(S,)``, the absolute position each slot holds (-1: empty)."""
        cfg = self.cfg
        L, KV, hd = cfg.num_layers, cfg.num_kv_heads, cfg.hd
        S = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
        kvdt, dev = _kv_dtype(cfg), self.device
        return {
            "k": torch.zeros((L, batch_size, S, KV, hd), dtype=kvdt, device=dev),
            "v": torch.zeros((L, batch_size, S, KV, hd), dtype=kvdt, device=dev),
            "kpos": torch.full((S,), -1, dtype=torch.int32, device=dev),
        }

    def decode_step(self, cache: Dict[str, torch.Tensor], tokens: torch.Tensor, t: int):
        """``tokens``: (B,) the current input token of each row; ``t``:
        the position (one for the whole batch, as in the reference).
        Returns ``(logits (B, V) float32, cache)``: the cache's ``k``/``v``
        are written in place (one row each under ``dus``/``ring``/
        ``deferred``) and ``kpos`` is replaced."""
        cfg = self.cfg
        t = int(t)
        tokens = tokens.to(self.device)
        Bsz = tokens.shape[0]
        x = self._embed(tokens[:, None])
        pos = torch.full((Bsz, 1), t, dtype=torch.long, device=self.device)
        S = cache["k"].shape[2]
        slot = t % S
        at_slot = torch.arange(S, device=self.device) == slot
        kc_all, vc_all = cache["k"], cache["v"]
        if cfg.cache_update == "deferred":
            # mask the stale slot row during attention; the new rows are
            # attended explicitly and written once for all layers after
            kpos_mask = torch.where(at_slot, -1, cache["kpos"])
            k_rows, v_rows = [], []
            for layer, kc, vc in zip(self.layers, kc_all, vc_all):
                x, (k_new, v_new) = B.dense_block_decode(layer, x, cfg, kc, vc, t, pos,
                                                         kpos_mask)
                k_rows.append(k_new)
                v_rows.append(v_new)
            kpos = torch.where(at_slot, t, cache["kpos"]).to(torch.int32)
            ring_update_stacked(kc_all, torch.stack(k_rows), slot)
            ring_update_stacked(vc_all, torch.stack(v_rows), slot)
        else:
            kpos = torch.where(at_slot, t, cache["kpos"]).to(torch.int32)
            for layer, kc, vc in zip(self.layers, kc_all, vc_all):
                x, _ = B.dense_block_decode(layer, x, cfg, kc, vc, t, pos, kpos)
        cache = {"k": kc_all, "v": vc_all, "kpos": kpos}
        return self._head(x)[:, 0], cache


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    """An uninitialized :class:`Model` on ``device`` (the card unless
    ``device="cpu"``)."""
    return Model(cfg, device=device)


def _to_torch(a: Any) -> torch.Tensor:
    """A reference array (jax or numpy, bf16 included, or a tensor) as a
    CPU tensor, bit for bit."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def params_from_reference(cfg: ModelConfig, params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The reference's parameter tree (nested dicts of arrays, the layers
    stacked on a leading L axis) as the port's parameters: a dict of CPU
    tensors keyed by :class:`Model` parameter names, for
    ``Model.load_state_dict``.  Values are copied bit for bit."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(f"the {cfg.family!r} family is not ported yet: ROADMAP Queue 1")
    out: Dict[str, torch.Tensor] = {"embed.vocab": _to_torch(params["embed"]["vocab"]),
                                    "final_norm": _to_torch(params["final_norm"])}
    if "lm_head" in params:
        out["lm_head"] = _to_torch(params["lm_head"])

    def walk(tree: Mapping[str, Any], prefix: str) -> None:
        for key, val in tree.items():
            if isinstance(val, Mapping):
                walk(val, f"{prefix}{key}.")
                continue
            stacked = _to_torch(val)
            if stacked.shape[0] != cfg.num_layers:
                raise ValueError(f"layers.{prefix}{key}: leading axis {stacked.shape[0]}, "
                                 f"want {cfg.num_layers} layers")
            for layer in range(cfg.num_layers):
                out[f"layers.{layer}.{prefix}{key}"] = stacked[layer].clone()

    walk(params["layers"], "")
    return out


def _reference_key(name: str) -> Tuple[str, int]:
    """A port parameter name as ``(reference key, layer)``: a layer's
    ``layers.<i>.<rest>`` is the stacked reference leaf ``layers.<rest>``
    at index ``i``; any other name is its own key (layer 0)."""
    parts = name.split(".")
    if parts[0] == "layers" and len(parts) > 2 and parts[1].isdigit():
        return ".".join(["layers"] + parts[2:]), int(parts[1])
    return name, 0


def reference_order(names: Iterable[str]) -> List[str]:
    """``names`` in the order ``jax.tree.leaves`` visits the reference's
    stacked tree (dict keys sorted at every level), each stacked leaf's
    layers in turn: the byte order of the reference's flattened tree."""
    def key(name):
        ref, layer = _reference_key(name)
        return tuple(ref.split(".")), layer

    return sorted(names, key=key)


def params_to_reference(cfg: ModelConfig, state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`params_from_reference`: tensors keyed by
    :class:`Model` parameter names (parameters, or anything shaped like
    them, such as AdamW moments) as the reference's nested tree, the
    layers stacked on a leading L axis.  Detached tensors on the inputs'
    device."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(f"the {cfg.family!r} family is not ported yet: ROADMAP Queue 1")
    flat: Dict[str, Any] = {}
    for name, t in state_dict.items():
        ref, layer = _reference_key(name)
        if ref.startswith("layers."):
            flat.setdefault(ref, [None] * cfg.num_layers)[layer] = t.detach()
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
