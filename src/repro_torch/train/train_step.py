"""Train and decode step factories: the loss, microbatched gradient
accumulation and the AdamW update (the port of the reference's
``repro.train.train_step``).

The reference's steps are pure functions the launcher jits; here they
run eagerly on the model's own parameters.  ``params`` is
:meth:`~repro_torch.models.model.Model.trainable`'s dict (the model's
parameters, in the reference's tree order): gradients are taken with
respect to exactly those tensors, and the update writes them in place,
as the reference donates its parameter buffers.  A dict that is not
the model's own parameters raises (:func:`check_params`).

A parameter the forward does not read (the encoder-decoder's
cross-attention biases) gets a zero gradient, as ``jax.grad`` gives it.
On a device mesh the parameters and the batch are DTensors
(:func:`repro_torch.distributed.sharding.shard_model`,
:func:`repro_torch.data.pipeline.shard_batch`): gradients come back
with their parameter's placements, and a micro-batch is the same rows
of the global batch as on one device, placed as the batch is.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.distributed.sharding import full_tensor, take_last
from repro_torch.models.model import Model
from repro_torch.train.optimizer import AdamWConfig, adamw_update

__all__ = ["AUX_WEIGHT", "check_params", "cross_entropy", "make_decode_step",
           "make_grad_step", "make_loss_fn", "make_prefill_step", "make_train_step"]

AUX_WEIGHT = 1e-2  # MoE load-balance loss weight


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy in float32: logsumexp minus the label's
    logit (on a mesh, picked from the vocab shards: :func:`take_last`)."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = take_last(logits, labels)
    return torch.mean(lse - ll)


def check_params(model: Model, params: Dict[str, torch.Tensor]) -> None:
    """Raise unless ``params`` holds exactly ``model``'s parameters (the
    same tensor objects, as :meth:`Model.trainable` gives them): the
    forward reads the module's own parameters, so any other dict would be
    silently ignored."""
    own = {id(p) for p in model.parameters()}
    given = {id(v) for v in params.values()}
    if given != own or len(params) != len(own):
        raise ValueError("params must be the model's own parameters "
                         "(Model.trainable()), not copies or a subset")


def make_loss_fn(model: Model):
    """``loss_fn(params, batch) -> (loss, metrics)``: cross-entropy plus
    ``AUX_WEIGHT * aux`` of the model's forward on ``batch["tokens"]``
    with the batch's ``positions``, ``patch_embeds`` and ``enc_embeds``
    where it has them (``params`` are the model's own: see the module
    docstring)."""
    def loss_fn(params, batch):
        check_params(model, params)
        logits, aux = model.forward(batch["tokens"], batch.get("positions"),
                                    patch_embeds=batch.get("patch_embeds"),
                                    enc_embeds=batch.get("enc_embeds"))
        loss = cross_entropy(logits, batch["labels"]) + AUX_WEIGHT * aux
        return loss, {"xent": loss, "moe_aux": aux}

    return loss_fn


def _make_compute_grads(model: Model):
    """The shared gradient half of the step factories:
    ``compute_grads(params, batch) -> (loss, metrics, grads)`` with
    ``cfg.microbatches`` accumulation steps.  With one micro-batch the
    gradients are in the parameters' dtype; with more they are float32,
    accumulated as ``acc + g / n_micro`` per micro-batch, with the loss
    summed as ``loss / n_micro``."""
    cfg = model.cfg
    loss_fn = make_loss_fn(model)
    n_micro = max(cfg.microbatches, 1)

    def grads_of(params, batch):
        with torch.enable_grad():
            loss, metrics = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, list(params.values()), materialize_grads=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, {k: _placed_like(g, p) for (k, p), g in
                                        zip(params.items(), grads)}

    def compute_grads(params, batch):
        if n_micro == 1:
            return grads_of(params, batch)
        gacc = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
        lacc = torch.zeros((), dtype=torch.float32, device=model.device)
        for i in range(n_micro):
            loss, _, grads = grads_of(params, _micro_batch(batch, i, n_micro))
            with torch.no_grad():
                for k, g in grads.items():
                    gacc[k] = gacc[k] + g.to(torch.float32) / n_micro
                lacc = lacc + full_tensor(loss) / n_micro
        zero = torch.zeros((), dtype=torch.float32, device=model.device)
        return lacc, {"xent": lacc, "moe_aux": zero}, gacc

    return compute_grads


def _placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``g`` with ``p``'s placements (a DTensor gradient may come back
    partial over the batch axes: this sums it); a plain gradient as it is."""
    if hasattr(g, "placements") and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _micro_batch(batch: Dict[str, torch.Tensor], i: int, n: int) -> Dict[str, torch.Tensor]:
    """The ``i``-th of ``n`` equal micro-batches: rows ``[i B/n, (i+1)
    B/n)`` of every entry (M-RoPE ``positions`` on dim 1).  On a mesh the
    rows are cut from the gathered batch and placed again as it was."""
    out = {}
    for k, v in batch.items():
        dim = 1 if k == "positions" else 0
        if hasattr(v, "placements"):
            from repro_torch.data.pipeline import shard_batch

            full = v.full_tensor()
            rows = full.shape[dim] // n
            out.update(shard_batch({k: full.narrow(dim, i * rows, rows)}, v.device_mesh))
        else:
            out[k] = v.reshape(*v.shape[:dim], n, v.shape[dim] // n, *v.shape[dim + 1:]).select(
                dim, i)
    return out


def make_grad_step(model: Model, opt_cfg: AdamWConfig):
    """The split factories the wire-routed gradient path needs
    (:class:`repro_torch.train.grad_wire.GradWire` runs between them):
    ``grad_fn(params, batch) -> (loss, metrics, grads)`` and
    ``update_fn(params, opt_state, grads, loss, metrics) -> (params,
    opt_state, metrics)``.  :func:`make_train_step` composes them."""
    def update_fn(params, opt_state, grads, loss, metrics):
        params, opt_state, opt_metrics = adamw_update(params, grads, opt_state, opt_cfg)
        return params, opt_state, {**metrics, **opt_metrics, "loss": loss}

    return _make_compute_grads(model), update_fn


def make_train_step(model: Model, opt_cfg: AdamWConfig):
    """The fused ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``: :func:`make_grad_step`'s halves composed, so
    the split path runs exactly its ops."""
    grad_fn, update_fn = make_grad_step(model, opt_cfg)

    def train_step(params, opt_state, batch):
        loss, metrics, grads = grad_fn(params, batch)
        return update_fn(params, opt_state, grads, loss, metrics)

    return train_step


def make_prefill_step(model: Model):
    """``prefill_step(batch) -> (last_logits, cache)``: :meth:`Model.prefill`
    on ``batch["tokens"]`` (with its ``patch_embeds`` for vlm)."""
    def prefill_step(batch: Dict[str, torch.Tensor]):
        return model.prefill(batch["tokens"], patch_embeds=batch.get("patch_embeds"))

    return prefill_step


def make_decode_step(model: Model):
    def decode_step(cache: Dict[str, torch.Tensor], tokens: torch.Tensor,
                    t: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        return model.decode_step(cache, tokens, t)

    return decode_step
