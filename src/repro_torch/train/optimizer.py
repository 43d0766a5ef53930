"""AdamW on dicts of tensors: the port of the reference's
``repro.train.optimizer``.

Plain functions over ``{name: tensor}`` dicts with the reference's
float32 arithmetic: moments in ``moment_dtype`` (bf16 for the giants),
global-norm clipping, linear warmup plus cosine decay, decoupled weight
decay.  The step counter is a 0-d int32 tensor on the parameters' device
and the bias corrections ``b ** step`` and the schedule are float32
tensors there, so a step reads nothing back to the host.

Weight decay follows the rank a leaf has in the *reference's* tree,
where every layer's leaves are stacked on a leading axis: a leaf of a
stacked subtree (``layers.*``, ``encoder.layers.*``, ``xattn.*``) is
decayed whatever its per-layer rank (its norms and biases are 2-D
there), any other leaf when it has two or more dimensions (so
``final_norm`` and ``encoder.final_norm`` are not, ``embed.vocab`` and
``lm_head`` are).  The same rule holds for a tree already in the
stacked layout.

``adamw_update`` updates the parameters and moments in place (the
reference donates their buffers to its jitted step) and returns them.
On a device mesh the parameters, gradients and moments are DTensors of
one placement each: the update runs on every rank's shard, and
:func:`global_norm` sums the shards' squares into the full norm, so the
clipping and the metrics are the unsharded run's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Tuple

import torch

from repro_torch.distributed.sharding import full_tensor, replicate_on

__all__ = [
    "AdamWConfig",
    "adamw_update",
    "decays",
    "dequantize_grad_int8",
    "global_norm",
    "init_opt_state",
    "lr_schedule",
    "quantize_grad_int8",
]

_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    moment_dtype: str = "float32"


def _mdt(cfg: AdamWConfig) -> torch.dtype:
    return _MOMENT_DTYPES[cfg.moment_dtype]


#: the name prefixes of the reference's stacked subtrees
STACKED_PREFIXES = ("layers.", "encoder.layers.", "xattn.")


def decays(name: str, p: torch.Tensor) -> bool:
    """Whether AdamW decays the leaf ``name``: its rank in the
    reference's stacked tree is at least 2."""
    return name.startswith(STACKED_PREFIXES) or p.dim() >= 2


def init_opt_state(params: Mapping[str, torch.Tensor], cfg: AdamWConfig) -> Dict:
    """Zero moments beside each parameter and a zero int32 step."""
    mdt = _mdt(cfg)
    dev = next(iter(params.values())).device
    return {
        "mu": {k: torch.zeros_like(p, dtype=mdt) for k, p in params.items()},
        "nu": {k: torch.zeros_like(p, dtype=mdt) for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def lr_schedule(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """Linear warmup + cosine decay, float32 (``step``: an int tensor)."""
    s = step.to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1 + torch.cos(math.pi * prog))


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves of the float32 sums of squares, added
    leaf by leaf in the tree's order as the reference's ``sum`` does.  A
    DTensor leaf's sum is reduced over its shards first; the norm is then
    a plain 0-d tensor."""
    total = None
    for g in tree.values():
        sq = full_tensor(g.to(torch.float32).square().sum())
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params: Dict[str, torch.Tensor], grads: Mapping[str, torch.Tensor],
                 state: Dict, cfg: AdamWConfig) -> Tuple[Dict, Dict, Dict]:
    """One AdamW step; returns ``(params, state, metrics)``.  ``params``
    and the moments are written in place; ``metrics`` holds the raw
    ``grad_norm`` and the step's ``lr`` (0-d float32 tensors)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = lr_schedule(step, cfg)
    mdt = _mdt(cfg)
    stepf = step.to(torch.float32)
    # the bases filled on the device: no host-to-device copy per step
    b1c = 1 - torch.pow(torch.full((), cfg.b1, device=stepf.device), stepf)
    b2c = 1 - torch.pow(torch.full((), cfg.b2, device=stepf.device), stepf)
    mu, nu = state["mu"], state["nu"]
    first = next(iter(params.values()))
    if hasattr(first, "device_mesh"):  # the scalars join the DTensor arithmetic replicated
        scale, lr, b1c, b2c = (replicate_on(t, first.device_mesh) for t in (scale, lr, b1c, b2c))
    for name, p in params.items():
        g = grads[name].to(torch.float32) * scale
        m32 = mu[name].to(torch.float32) * cfg.b1 + g * (1 - cfg.b1)
        v32 = nu[name].to(torch.float32) * cfg.b2 + g.square() * (1 - cfg.b2)
        update = (m32 / b1c) / (torch.sqrt(v32 / b2c) + cfg.eps)
        if decays(name, p):  # decoupled weight decay, by the reference's rank
            update = update + cfg.weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr * update)
        mu[name].copy_(m32.to(mdt))
        nu[name].copy_(v32.to(mdt))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, {"mu": mu, "nu": nu, "step": step}, metrics


# ---------------------------------------------------------------------------
# int8 gradient compression (per-tensor, symmetric)
# ---------------------------------------------------------------------------

def quantize_grad_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization: ``g ~ q * scale``."""
    gf = g.to(torch.float32)
    amax = gf.abs().max() + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_grad_int8(q: torch.Tensor, scale: torch.Tensor,
                         dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)
