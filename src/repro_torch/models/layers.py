"""Core transformer layers: RMSNorm, RoPE and M-RoPE, chunked
(flash-style) attention with GQA / sliding window, single-token decode
attention against a KV cache, and the gated MLP.

The port of the reference's ``repro.models.layers``, written as it writes
them: where the reference asks for a float32 product
(``preferred_element_type``) the operands are upcast first (bf16 values
are exact in float32), the softmax is spelled out, and
norms and rotary angles in float32.  No library attention kernel is used,
so the port computes the reference's operations.  The reference's
sharding annotations are kept at its sites (:func:`~repro_torch.distributed.sharding.constrain`,
a no-op without a mesh), and the rotary angles go through ``replicated``,
so that under a mesh they combine with the DTensor activations.  Under a
mesh the attention runs on each rank's own batch rows and heads
(:func:`_flash_on_shards`), decode attention on each rank's block of
cache slots (:func:`_decode_attention_on_shards`), and a ring write goes
to the rank that owns the slot (:func:`_ring_write`).
``flash_attention`` is differentiated by the reference's chunked backward
(``_flash_vjp``), a :class:`torch.autograd.Function` here, never by
autograd through the chunk loop.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (
    active,
    constrain,
    local_offset,
    replicated,
    use_rules,
)

__all__ = [
    "ATTN_CHUNK",
    "FlashAttention",
    "decode_attention",
    "flash_attention",
    "gated_mlp",
    "init_dense",
    "init_norm",
    "mrope",
    "ring_update",
    "ring_update_stacked",
    "rms_norm",
    "rope",
]

ATTN_CHUNK = 1024  # kv-chunk for online softmax


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def init_dense(gen: torch.Generator, d_in: int, d_out: int, dtype,
               device=None) -> torch.Tensor:
    """A ``(d_in, d_out)`` weight: standard normal in float32 scaled by
    ``1/sqrt(d_in)``, cast to ``dtype`` (the reference's distribution,
    drawn from ``gen``)."""
    scale = 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device if device is not None else gen.device)
    return (w * scale).to(dtype)


def init_norm(d: int, dtype, device=None) -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def _rope_angles(positions: torch.Tensor, dims: int, theta: float) -> torch.Tensor:
    """(..., dims/2) float32 angles for integer positions."""
    exps = -torch.arange(0, dims, 2, dtype=torch.float32, device=positions.device) / dims
    # a Python base: no host-to-device copy (and no host sync) per call
    freqs = replicated(torch.pow(float(theta), exps))
    return positions[..., None].float() * freqs


def _apply_angles(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); angles: (B, S, D/2).  Split halves, not
    interleaved pairs."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
         theta: float = 1e4) -> Tuple[torch.Tensor, torch.Tensor]:
    """Standard RoPE.  positions: (B, S) int."""
    ang = _rope_angles(positions, q.shape[-1], theta)
    return _apply_angles(q, ang).to(q.dtype), _apply_angles(k, ang).to(k.dtype)


def mrope(q: torch.Tensor, k: torch.Tensor, positions3: torch.Tensor,
          sections: Tuple[int, int, int], theta: float = 1e4):
    """Multimodal RoPE (Qwen2-VL): the head_dim/2 rotation pairs are split
    into (t, h, w) sections, each rotated by its own position stream.
    positions3: (3, B, S) int (equal streams for text tokens, spatial ids
    for vision patches)."""
    d = q.shape[-1]
    assert sum(sections) == d // 2, (sections, d)
    exps = -(torch.arange(0, d, 2, dtype=torch.float32, device=positions3.device) / d)
    freqs = replicated(torch.pow(float(theta), exps))  # the full ladder; each section its slice
    parts, lo = [], 0
    for i, sec in enumerate(sections):
        parts.append(positions3[i][..., None].float() * freqs[lo:lo + sec])
        lo += sec
    ang = torch.cat(parts, dim=-1)  # (B, S, d/2)
    return _apply_angles(q, ang).to(q.dtype), _apply_angles(k, ang).to(k.dtype)


# ---------------------------------------------------------------------------
# chunked online-softmax attention (flash-style forward)
# ---------------------------------------------------------------------------

def _mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
          window: Optional[int]) -> torch.Tensor:
    """(Sq, Sk) boolean validity mask from absolute positions."""
    ok = torch.ones((qpos.shape[-1], kpos.shape[-1]), dtype=torch.bool, device=qpos.device)
    if causal:
        ok = ok & (qpos[:, None] >= kpos[None, :])
    if window is not None:
        ok = ok & (qpos[:, None] - kpos[None, :] < window)
    return ok


def _heads_shardable(H: int) -> bool:
    """True iff the merged H dim divides the active mesh's heads axis:
    the merged-head layout then lets the score tensors shard.  For head
    counts that do not divide it (qwen2's 14, qwen2-vl's 12) and with no
    mesh, the split (KVH, G) layout is kept."""
    mesh, rules = active()
    if mesh is None:
        return False
    return rules.resolve("heads", mesh, H) is not None


def _flash_forward(q, k, v, causal, window, q_offset, chunk, merged):
    """Online-softmax forward; returns (out, m, l) with float32 stats.
    ``merged`` keeps the heads merged (H = KVH*G, k/v repeated per
    chunk); otherwise the split (KVH, G) layout."""
    B, Sq, H, D = q.shape
    _, Sk, KVH, _ = k.shape
    G = H // KVH
    scale = 1.0 / math.sqrt(D)

    nchunks = max(Sk // chunk, 1)
    chunk = Sk // nchunks
    assert Sk % nchunks == 0, (Sk, chunk)

    dev = q.device
    qpos = q_offset + torch.arange(Sq, device=dev)
    qq = q if merged else q.reshape(B, Sq, KVH, G, D)
    qf = qq.float()

    acc = torch.zeros((B, Sq, H, D), dtype=torch.float32, device=dev)
    m = torch.full((B, Sq, H), -math.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Sq, H), dtype=torch.float32, device=dev)
    for c in range(nchunks):
        kb = k[:, c * chunk:(c + 1) * chunk]
        vb = v[:, c * chunk:(c + 1) * chunk]
        kpos = c * chunk + torch.arange(chunk, device=dev)
        if merged:
            kb = kb.repeat_interleave(G, dim=2)      # (B, C, H, D)
            vb = vb.repeat_interleave(G, dim=2)
            s = torch.einsum("bqhd,bchd->bqhc", qf, kb.float()) * scale
        else:
            s = torch.einsum("bqkgd,bckd->bqkgc", qf, kb.float()) * scale
            s = s.reshape(B, Sq, H, chunk)
        ok = _mask(qpos, kpos, causal, window)[None, :, None, :]  # (1, Sq, 1, chunk)
        s = torch.where(ok, s, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # guard fully-masked rows (m_new == -inf)
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(ok, p, 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * alpha + p.sum(dim=-1)
        pv_in = p.to(v.dtype).float()
        if merged:
            pv = torch.einsum("bqhc,bchd->bqhd", pv_in, vb.float())
        else:
            pv = torch.einsum(
                "bqkgc,bckd->bqkgd", pv_in.reshape(B, Sq, KVH, G, chunk), vb.float(),
            ).reshape(B, Sq, H, D)
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-37)
    return out.to(q.dtype), m, l


def _flash_backward(q, k, v, out, m, l, do, causal, window, q_offset, chunk, merged):
    """The reference's chunked flash backward (``_flash_vjp``'s ``bwd``):
    ``p`` is recomputed per kv chunk from the saved float32 stats,
    ``delta = rowsum(do * out)``, ``dq`` accumulates in float32 across
    chunks (``ds`` cast to ``q.dtype`` before its product), and each
    chunk's ``dk``/``dv`` are cast to ``k.dtype``/``v.dtype``.  Returns
    ``(dq, dk, dv)``."""
    B, Sq, H, D = q.shape
    _, Sk, KVH, _ = k.shape
    G = H // KVH
    scale = 1.0 / math.sqrt(D)
    nchunks = max(Sk // chunk, 1)
    ck = Sk // nchunks

    dev = q.device
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    inv_l = 1.0 / torch.clamp(l, min=1e-37)
    dof = do.float()
    delta = torch.einsum("bqhd,bqhd->bqh", dof, out.float())
    qpos = q_offset + torch.arange(Sq, device=dev)
    qgf = (q if merged else q.reshape(B, Sq, KVH, G, D)).float()
    dogf = dof if merged else dof.reshape(B, Sq, KVH, G, D)
    if not merged:
        m_safe = m_safe.reshape(B, Sq, KVH, G)
        inv_l = inv_l.reshape(B, Sq, KVH, G)
        delta = delta.reshape(B, Sq, KVH, G)

    dq = torch.zeros((B, Sq, H, D), dtype=torch.float32, device=dev)
    dks, dvs = [], []
    for c in range(nchunks):
        kb = k[:, c * ck:(c + 1) * ck]
        vb = v[:, c * ck:(c + 1) * ck]
        kpos = c * ck + torch.arange(ck, device=dev)
        ok = _mask(qpos, kpos, causal, window)  # (Sq, ck)
        if merged:
            kbr = kb.repeat_interleave(G, dim=2).float()  # (B, C, H, D)
            vbr = vb.repeat_interleave(G, dim=2).float()
            s = torch.einsum("bqhd,bchd->bqhc", qgf, kbr) * scale
            p = torch.exp(s - m_safe[..., None]) * inv_l[..., None]
            p = torch.where(ok[None, :, None, :], p, 0.0)
            dv_f = torch.einsum("bqhc,bqhd->bchd", p, dogf)
            dp = torch.einsum("bqhd,bchd->bqhc", dogf, vbr)
            ds = p * (dp - delta[..., None]) * scale
            dq = dq + torch.einsum("bqhc,bchd->bqhd", ds.to(q.dtype).float(), kbr)
            dk_f = torch.einsum("bqhc,bqhd->bchd", ds, qgf)
            dk_c = dk_f.reshape(B, ck, KVH, G, D).sum(3)
            dv_c = dv_f.reshape(B, ck, KVH, G, D).sum(3)
        else:
            kbf, vbf = kb.float(), vb.float()
            s = torch.einsum("bqkgd,bckd->bqkgc", qgf, kbf) * scale
            p = torch.exp(s - m_safe[..., None]) * inv_l[..., None]
            p = torch.where(ok[None, :, None, None, :], p, 0.0)
            dv_c = torch.einsum("bqkgc,bqkgd->bckd", p, dogf)
            dp = torch.einsum("bqkgd,bckd->bqkgc", dogf, vbf)
            ds = p * (dp - delta[..., None]) * scale
            dq = dq + torch.einsum("bqkgc,bckd->bqkgd", ds.to(q.dtype).float(),
                                   kbf).reshape(B, Sq, H, D)
            dk_c = torch.einsum("bqkgc,bqkgd->bckd", ds, qgf)
        dks.append(dk_c.to(k.dtype))
        dvs.append(dv_c.to(v.dtype))
    return dq.to(q.dtype), torch.cat(dks, dim=1), torch.cat(dvs, dim=1)


class FlashAttention(torch.autograd.Function):
    """Chunked online-softmax attention with the reference's custom VJP:
    the forward is :func:`_flash_forward` and saves ``(q, k, v, out, m,
    l)``; the backward is :func:`_flash_backward`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, chunk, merged):
        out, m, l = _flash_forward(q, k, v, causal, window, q_offset, chunk, merged)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.config = (causal, window, q_offset, chunk, merged)
        return out

    @staticmethod
    def backward(ctx, do):
        dq, dk, dv = _flash_backward(*ctx.saved_tensors, do, *ctx.config)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,          # (B, Sq, H, D)
    k: torch.Tensor,          # (B, Sk, KVH, D)
    v: torch.Tensor,          # (B, Sk, KVH, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    chunk: int = ATTN_CHUNK,
    merged: Optional[bool] = None,
) -> torch.Tensor:
    """Online-softmax attention over kv chunks; GQA via head grouping.
    Never materializes the (Sq, Sk) score matrix.  ``merged`` picks the
    merged-head layout; by default it is taken, as the reference takes
    it, when the heads divide the active mesh's heads axis
    (:func:`_heads_shardable`; on one card the split layout).
    Differentiable through :class:`FlashAttention`'s chunked backward."""
    if merged is None:
        merged = _heads_shardable(q.shape[2])
    if active()[0] is not None:
        return _flash_on_shards(q, k, v, causal, window, q_offset, chunk, merged)
    return FlashAttention.apply(q, k, v, causal, window, q_offset, chunk, merged)


def _flash_on_shards(q, k, v, causal, window, q_offset, chunk, merged):
    """:func:`flash_attention` under a mesh, where ``q``, ``k`` and ``v``
    are DTensors: attention is independent across batch rows and query
    heads, so each rank runs :class:`FlashAttention` on plain tensors of
    its own rows and heads (``q``'s batch shards, its heads over the
    ``"heads"`` axes where they divide them), against the key/value heads those query heads
    read (gathered over the head axes; their gradients are summed over
    them), and the output keeps ``q``'s placements.  Each rank's score
    and cotangent blocks are then the ``("batch", None, "heads", None)``
    shards that the reference's constraints inside its chunk loop ask
    for."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = q.device_mesh
    heads = active()[1].resolve("heads", mesh, q.shape[2])
    heads = (heads,) if isinstance(heads, str) else heads or ()
    # the query heads split over the heads axes wherever they divide them,
    # however ``q`` arrives (a cross-attention's query may come partial)
    q_pl = tuple(p if p == Shard(0) else
                 Shard(2) if p == Shard(2) or name in heads else Replicate()
                 for p, name in zip(q.placements, mesh.mesh_dim_names))
    kv_pl = tuple(p if p == Shard(0) else Replicate() for p in q_pl)
    kv_grad = tuple(Partial() if p == Shard(2) else t for p, t in zip(q_pl, kv_pl))
    q = q.redistribute(mesh, q_pl)
    ql = q.to_local()
    kl = k.redistribute(mesh, kv_pl).to_local(grad_placements=kv_grad)
    vl = v.redistribute(mesh, kv_pl).to_local(grad_placements=kv_grad)
    G = q.shape[2] // k.shape[2]
    lo = local_offset(q)[2]
    hi = lo + ql.shape[2]
    if lo % G == 0 and hi % G == 0:  # whole query groups: their key/value heads
        kl, vl = kl[:, :, lo // G:hi // G], vl[:, :, lo // G:hi // G]
    else:  # a group split across ranks: each query head's own key/value head
        kl = kl.repeat_interleave(G, dim=2)[:, :, lo:hi]
        vl = vl.repeat_interleave(G, dim=2)[:, :, lo:hi]
    with use_rules(None):  # plain tensors: no annotation applies inside
        out = FlashAttention.apply(ql, kl, vl, causal, window, q_offset, chunk, merged)
    return DTensor.from_local(out, mesh, q_pl, run_check=False)


def ring_update(cache: torch.Tensor, new: torch.Tensor, slot) -> torch.Tensor:
    """Write one token into a ring-buffer cache at ``slot`` along axis 1,
    in place (the reference's one-device ``dynamic_update_slice`` on a
    donated buffer: traffic is one row); returns ``cache``.  Under a mesh
    that shards the sequence (``"kv_seq"``) the write goes to the owning
    shard alone (:func:`_ring_write`).
    cache: (B, S, KV, hd); new: (B, 1, KV, hd)."""
    return _ring_write(cache, new, int(slot), 1)


def ring_update_stacked(cache: torch.Tensor, new: torch.Tensor, slot) -> torch.Tensor:
    """Batched deferred cache write, every layer at once, in place.
    cache: (L, B, S, KV, hd); new: (L, B, 1, KV, hd).  Returns ``cache``."""
    return _ring_write(cache, new, int(slot), 2)


def _ring_write(cache: torch.Tensor, new: torch.Tensor, s: int, dim: int) -> torch.Tensor:
    """``cache`` with ``new`` written at index ``s`` of its sequence dim
    ``dim``, in place.  Without a mesh, or where the rules leave the
    sequence whole, one in-place slice write.  Under a mesh that shards
    it, the reference's ``shard_map`` branch: ``new`` is placed as the
    cache is, its sequence dim whole, and each rank writes the row into
    its own block only when ``0 <= s - offset < S_local`` (``offset`` its
    block's first slot): one row of traffic, and no collective."""
    mesh, rules = active()
    if mesh is None or rules.resolve("kv_seq", mesh, cache.shape[dim]) is None:
        cache.narrow(dim, s, 1).copy_(new.to(cache.dtype))
        return cache
    from torch.distributed.tensor import Replicate

    pl = [Replicate() if p.is_shard(dim) else p for p in cache.placements]
    # every rank places the row (a collective when ``new`` is laid out
    # otherwise); only the owner writes it
    row = replicated(new).redistribute(cache.device_mesh, pl).to_local()
    block = cache.to_local()
    local = s - local_offset(cache)[dim]
    if 0 <= local < block.shape[dim]:
        block.narrow(dim, local, 1).copy_(row.to(cache.dtype))
    return cache


def decode_attention(
    q: torch.Tensor,        # (B, 1, H, D)
    k_cache: torch.Tensor,  # (B, S, KVH, D)
    v_cache: torch.Tensor,
    t,                      # current position (int or 0-d tensor)
    *,
    window: Optional[int] = None,
    kpos: Optional[torch.Tensor] = None,  # (S,) absolute position per slot (-1 = empty)
    current: Optional[tuple] = None,      # deferred write: (k_new, v_new) (B,1,KVH,D)
) -> torch.Tensor:
    """Single-token attention against a KV cache, with an explicit
    softmax over the valid slots (under a mesh on each rank's cache
    block: :func:`_decode_attention_on_shards`)."""
    if active()[0] is not None:
        return _decode_attention_on_shards(q, k_cache, v_cache, t, window, kpos, current)
    B, _, H, D = q.shape
    _, S, KVH, _ = k_cache.shape
    G = H // KVH
    qg = q.reshape(B, KVH, G, D)
    if kpos is None:
        kpos = torch.arange(S, device=q.device)
        valid = kpos <= t
    else:
        valid = (kpos >= 0) & (kpos <= t)
    if window is not None:
        valid = valid & (kpos > t - window)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float()) / math.sqrt(D)
    s = torch.where(valid[None, None, None, :], s, -math.inf)
    if current is not None:
        # deferred-write mode: the current token's (k, v) are not in the
        # cache yet; attend to them explicitly (the cache row at the slot
        # is stale and masked out by the caller's kpos)
        k_cur, v_cur = current
        s_cur = torch.einsum(
            "bkgd,bkd->bkg", qg.float(), k_cur[:, 0].to(qg.dtype).float(),
        )[..., None] / math.sqrt(D)
        s = torch.cat([s, s_cur], dim=-1)
        p = torch.softmax(s, dim=-1)
        p_cache, p_cur = p[..., :-1], p[..., -1:]
        out = torch.einsum(
            "bkgs,bskd->bkgd", p_cache.to(v_cache.dtype).float(), v_cache.float(),
        ) + p_cur * v_cur[:, 0, :, None, :].float()
        return out.reshape(B, 1, H, D).to(q.dtype)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(B, 1, H, D).to(q.dtype)


def _decode_attention_on_shards(q, k_cache, v_cache, t, window, kpos, current):
    """:func:`decode_attention` under a mesh, where the caches are
    DTensors sharded on batch rows (dim 0) and sequence slots (dim 1) at
    most.  Each rank scores its query rows against its own block of slots;
    the softmax's max and sum and the weighted values are then reduced
    over the mesh dims that shard the slots (an all-reduce each, of
    ``(B, KV, G)`` statistics and the ``(B, KV, G, hd)`` output): the
    reference's cross-shard softmax reductions, written out.  Returns a
    ``(B, 1, H, D)`` DTensor sharded on the cache's batch dims."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = k_cache.device_mesh
    kv_pl = tuple(k_cache.placements)
    if tuple(v_cache.placements) != kv_pl or any(
            not (p.is_replicate() or p in (Shard(0), Shard(1))) for p in kv_pl):
        raise ValueError(f"decode_attention on a mesh takes caches sharded on batch rows and "
                         f"slots alike; got {kv_pl} and {tuple(v_cache.placements)}")
    row_pl = tuple(Shard(0) if p == Shard(0) else Replicate() for p in kv_pl)

    def reduce(x, op):  # ``x`` summed (op: "sum") or maxed over the slot shards
        if row_pl == kv_pl:
            return x
        pl = tuple(Partial(op) if p == Shard(1) else r for p, r in zip(kv_pl, row_pl))
        return DTensor.from_local(x, mesh, pl, run_check=False).redistribute(
            mesh, row_pl).to_local()

    kl, vl = k_cache.to_local(), v_cache.to_local()
    B_l, S_l, KVH, D = kl.shape
    H = q.shape[2]
    G = H // KVH
    lo = local_offset(k_cache)[1]
    qg = replicated(q).redistribute(mesh, row_pl).to_local().reshape(B_l, KVH, G, D)
    if kpos is None:
        kp = torch.arange(lo, lo + S_l, device=kl.device)
        valid = kp <= t
    else:
        kp = replicated(kpos).redistribute(mesh, [Replicate()] * mesh.ndim).to_local()
        kp = kp[lo:lo + S_l]
        valid = (kp >= 0) & (kp <= t)
    if window is not None:
        valid = valid & (kp > t - window)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), kl.float()) / math.sqrt(D)
    s = torch.where(valid[None, None, None, :], s, -math.inf)
    m = reduce(s.amax(dim=-1), "max")
    if current is not None:
        k_cur, v_cur = (replicated(c).redistribute(mesh, row_pl).to_local() for c in current)
        s_cur = torch.einsum("bkgd,bkd->bkg", qg.float(),
                             k_cur[:, 0].to(qg.dtype).float()) / math.sqrt(D)
        m = torch.maximum(m, s_cur)
    p = torch.exp(s - m[..., None])
    l = reduce(p.sum(dim=-1), "sum")
    if current is not None:
        p_cur = torch.exp(s_cur - m)
        l = l + p_cur
    p = p / l[..., None]
    out = reduce(torch.einsum("bkgs,bskd->bkgd", p.to(vl.dtype).float(), vl.float()), "sum")
    if current is not None:
        out = out + (p_cur / l)[..., None] * v_cur[:, 0, :, None, :].float()
    out = out.reshape(B_l, 1, H, D).to(q.dtype)
    return DTensor.from_local(out, mesh, row_pl, run_check=False)


# ---------------------------------------------------------------------------
# gated MLP (SwiGLU family)
# ---------------------------------------------------------------------------

_ACTIVATIONS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default
    "relu": F.relu,
}


def gated_mlp(p, x: torch.Tensor, activation: str = "silu") -> torch.Tensor:
    """``p`` carries ``w_gate``, ``w_in`` and ``w_out``."""
    act = _ACTIVATIONS[activation]
    h = act(x @ p.w_gate) * (x @ p.w_in)
    h = constrain(h, "batch", None, "d_ff")
    return h @ p.w_out
