"""Chunked linear attention with decay: the recurrence behind Mamba2
(SSD, a scalar decay per head) and RWKV6 (Finch, a data-dependent decay
per channel).  The port of the reference's ``repro.models.linear_attn``.

State per head: S in R^{dk x dv}.

scalar decay (Mamba2, inclusive of the current token):
    S_t = exp(a_t) * S_{t-1} + k_t v_t^T          y_t = q_t @ S_t

vector decay (RWKV6, exclusive, plus the bonus u):
    S_t = diag(w_t) S_{t-1} + k_t v_t^T           y_t = q_t @ (S_{t-1} + diag(u) k_t v_t^T)

Training uses the chunkwise-parallel form (an intra-chunk attention
matrix and the state carried from chunk to chunk, the chunks looped in
Python as the reference scans them); decoding uses the single-step
update.  State and accumulators are float32; ``y`` comes back in ``v``'s
dtype.  The chunk length is the reference's, ``S // max(S // chunk, 1)``,
since the split sets the float summation order.

Numerical notes.  Vector decay: the chunk form rescales keys by
``exp(-cumsum(log w))``; each step's log decay is clamped to
``>= -LOG_CLAMP`` so the within-chunk cumulative stays in float32 range.
Scalar decay: the intra-chunk weight ``exp(cum_t - cum_tau)`` is taken
only on and below the diagonal (the exponent is ``-inf`` above it).  The
reference exponentiates the whole square and drops the entries above the
diagonal afterwards; those overflow to ``inf`` once a chunk's cumulative
log decay passes 88.7, and its gradient is then ``inf * 0 = NaN``.  The
forward values are the same in every entry the reference keeps.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = [
    "LOG_CLAMP",
    "SCALAR_CHUNK",
    "VEC_CHUNK",
    "chunked_scalar_decay",
    "chunked_vector_decay",
    "step_scalar_decay",
    "step_vector_decay",
]

LOG_CLAMP = 1.2   # max |log decay| per step for the vector-decay path
VEC_CHUNK = 32
SCALAR_CHUNK = 64


def _chunks(S: int, chunk: int) -> Tuple[int, int]:
    """The reference's split of a sequence of ``S``: ``(n, C)``, ``n =
    max(S // chunk, 1)`` chunks of ``C = S // n``.  Raises ``ValueError``
    where ``n`` does not divide ``S`` (the reference asserts it)."""
    n = max(S // chunk, 1)
    if S % n:
        raise ValueError(f"the chunked recurrence splits a sequence of {S} into {n} chunks "
                         f"(chunk {chunk}); {n} must divide {S}")
    return n, S // n


def _split_chunks(x: torch.Tensor, n: int) -> torch.Tensor:
    """(B, S, ...) -> (n, B, S/n, ...), a view, for the loop over chunks."""
    B, S = x.shape[:2]
    return x.reshape(B, n, S // n, *x.shape[2:]).movedim(1, 0)


# ---------------------------------------------------------------------------
# scalar decay (Mamba2 SSD)
# ---------------------------------------------------------------------------

def chunked_scalar_decay(
    q: torch.Tensor,            # (B, S, H, dk), or (B, S, dk): shared across heads
    k: torch.Tensor,            # (B, S, H, dk), or (B, S, dk)
    v: torch.Tensor,            # (B, S, H, dv)
    log_decay: torch.Tensor,    # (B, S, H), <= 0
    state0: Optional[torch.Tensor] = None,  # (B, H, dk, dv) float32
    chunk: int = SCALAR_CHUNK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(y (B, S, H, dv), final state (B, H, dk, dv))``.

    Mamba2's B/C projections are shared across heads (ngroups = 1): pass
    them 3-D; each chunk then takes the heads' products from the one
    ``(B, C, dk)`` block, and ``(B, S, H, dk)`` is never formed."""
    B, S = q.shape[:2]
    H, dv = v.shape[2], v.shape[3]
    dk = q.shape[-1]
    shared = q.dim() == 3
    n, C = _chunks(S, chunk)
    state = (torch.zeros((B, H, dk, dv), dtype=torch.float32, device=v.device)
             if state0 is None else state0.float())
    tri = torch.ones((C, C), dtype=torch.bool, device=v.device).tril()
    ys = []
    for qb, kb, vb, ldb in zip(*(_split_chunks(x.float(), n) for x in (q, k, v, log_decay))):
        cum = torch.cumsum(ldb, dim=1)                          # inclusive (B, C, H)
        decay_in = torch.exp(cum)                               # (B, C, H)
        # A[t, tau] = (q_t . k_tau) e^{cum_t - cum_tau}, tau <= t; the
        # exponent is -inf above the diagonal, so nothing overflows there
        rel = (cum[:, :, None, :] - cum[:, None, :, :]).permute(0, 3, 1, 2)  # (B, H, C, G)
        w = torch.exp(rel.masked_fill(~tri, float("-inf")))
        carry = torch.exp(cum[:, -1:, :] - cum)                 # e^{cum_C - cum_tau} (B, C, H)
        if shared:
            logits = torch.einsum("bck,bgk->bcg", qb, kb)[:, None]       # (B, 1, C, G)
            y_inter = torch.einsum("bck,bhkv->bchv", qb, state) * decay_in[..., None]
            k_state = torch.einsum("bck,bchv->bhkv", kb, vb * carry[..., None])
        else:
            logits = torch.einsum("bchk,bghk->bhcg", qb, kb)
            y_inter = torch.einsum("bchk,bhkv->bchv", qb * decay_in[..., None], state)
            k_state = torch.einsum("bchk,bchv->bhkv", kb * carry[..., None], vb)
        y_intra = torch.einsum("bhcg,bghv->bchv", logits * w, vb)
        state = state * torch.exp(cum[:, -1, :])[..., None, None] + k_state
        ys.append(y_inter + y_intra)
    y = torch.cat(ys, dim=1) if n > 1 else ys[0]
    return y.to(v.dtype), state


def step_scalar_decay(q, k, v, log_decay, state):
    """Decode step.  q, k: (B, H, dk); v: (B, H, dv); log_decay: (B, H);
    state: (B, H, dk, dv) float32.  Returns ``(y (B, H, dv), state)``."""
    state = state * torch.exp(log_decay.float())[..., None, None]
    state = state + torch.einsum("bhk,bhv->bhkv", k.float(), v.float())
    y = torch.einsum("bhk,bhkv->bhv", q.float(), state)
    return y.to(v.dtype), state


# ---------------------------------------------------------------------------
# vector decay (RWKV6)
# ---------------------------------------------------------------------------

def chunked_vector_decay(
    q: torch.Tensor,            # (B, S, H, dk)   ("r" in RWKV)
    k: torch.Tensor,            # (B, S, H, dk)
    v: torch.Tensor,            # (B, S, H, dv)
    log_decay: torch.Tensor,    # (B, S, H, dk), <= 0 (log w_t)
    bonus: torch.Tensor,        # (H, dk): u
    state0: Optional[torch.Tensor] = None,
    chunk: int = VEC_CHUNK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(y (B, S, H, dv), final state (B, H, dk, dv))``."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    n, C = _chunks(S, chunk)
    state = (torch.zeros((B, H, dk, dv), dtype=torch.float32, device=v.device)
             if state0 is None else state0.float())
    ld = torch.clamp(log_decay.float(), -LOG_CLAMP, 0.0)
    u = bonus.float()
    strict = torch.ones((C, C), dtype=torch.bool, device=v.device).tril(-1)
    ys = []
    for qb, kb, vb, ldb in zip(*(_split_chunks(x, n) for x in (q.float(), k.float(), v.float(),
                                                                ld))):
        cum = torch.cumsum(ldb, dim=1)                  # inclusive (B, C, H, dk)
        cum_ex = cum - ldb                              # exclusive
        q_in = qb * torch.exp(cum_ex)
        y_inter = torch.einsum("bchk,bhkv->bchv", q_in, state)
        k_resc = kb * torch.exp(-cum)
        A = torch.einsum("bchk,bghk->bhcg", q_in, k_resc)
        A = torch.where(strict, A, 0.0)                 # strictly lower triangular
        y_intra = torch.einsum("bhcg,bghv->bchv", A, vb)
        # the bonus (current token) term
        qk = torch.einsum("bchk,hk,bchk->bch", qb, u, kb)
        y_bonus = qk[..., None] * vb
        k_carry = kb * torch.exp(cum[:, -1:] - cum)
        state = state * torch.exp(cum[:, -1])[..., None] + torch.einsum(
            "bchk,bchv->bhkv", k_carry, vb)
        ys.append(y_inter + y_intra + y_bonus)
    y = torch.cat(ys, dim=1) if n > 1 else ys[0]
    return y.to(v.dtype), state


def step_vector_decay(q, k, v, log_decay, bonus, state):
    """Decode step.  q, k, log_decay: (B, H, dk); v: (B, H, dv); bonus:
    (H, dk); state: (B, H, dk, dv) float32."""
    qf, kf, vf = q.float(), k.float(), v.float()
    w = torch.exp(torch.clamp(log_decay.float(), -LOG_CLAMP, 0.0))
    kv = torch.einsum("bhk,bhv->bhkv", kf, vf)
    att = state + bonus.float()[None, :, :, None] * kv
    y = torch.einsum("bhk,bhkv->bhv", qf, att)
    state = state * w[..., None] + kv
    return y.to(v.dtype), state
