"""The port's recurrent families (``ssm``, ``rwkv``, ``hybrid``) and the
chunked linear attention against the JAX reference, on the CPU, at the
smoke configs of zamba2-2.7b, rwkv6-7b and an ``ssm`` variant (the
zamba2 smoke config with ``family="ssm"``).

* ``linear_attn``: the chunked scalar and vector forms against the
  reference's at several ``(S, chunk)`` splits (one chunk of 96, two of
  65, ...), with 3-D shared q/k and a carried ``state0``, float32 to
  1e-5 of the largest value (the two chunk forms sum in other orders),
  and no further from a float64 sequential oracle than twice the
  reference is; each chunked form against its own single steps; the split the
  reference asserts raises ``ValueError``; gradients against
  ``jax.grad`` to 1e-4.
* The reference's NaN: at a log decay of -1.5 a step the reference's
  scalar-decay gradients are NaN (``exp`` of the masked-out exponents
  overflows), the port's are finite and agree with a float64 sequential
  oracle's autograd.
* ``mamba2_block``/``_decode``, ``rwkv6_block``/``_decode`` and the
  causal conv at smoke width (float32 to 1e-5; bf16 within 5%).
* The model through ``params_from_reference``: float32 ``forward`` and
  40 ``decode_step`` s to 1e-4 with equal greedy tokens and equal
  caches, bf16 within 5% of the largest logit; ``ServeLoop`` tokens.
* ``prefill`` raises in both packages; the hybrid raises under
  ``cache_update="deferred"`` and where ``attn_every`` does not divide
  ``num_layers``.
* 4 steps of ``train()`` from the reference's step-0 checkpoint to
  1e-5 at ``microbatches`` 1 and 2; remat on equals remat off; the
  smoke hybrid at seq 64, where the reference's training turns NaN and
  the port's stays finite.
* AdamW's decay set, parameter and checkpoint round trips both ways
  (the float32 ``A_log``/``dt_bias``/``skip_D``/``u``/``w0`` inside bf16
  trees; the hybrid's unstacked ``shared`` block).
"""

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.configs.registry as rreg
import repro.launch.serve as rserve
import repro.launch.train as rtrain
import repro.models.linear_attn as rla
import repro.train.checkpoint as rckpt
import repro.train.optimizer as ropt
from repro.models import blocks as rblocks
from repro.models.model import build_model as ref_build_model

from repro_torch.configs import smoke_config
from repro_torch.launch import train as ptrain
from repro_torch.launch.serve import Request, ServeLoop
from repro_torch.models import blocks
from repro_torch.models import linear_attn as la
from repro_torch.models.model import (
    _split_name,
    build_model,
    params_from_reference,
    params_to_reference,
    reference_order,
)
from repro_torch.train import checkpoint as pckpt
from repro_torch.train import optimizer as popt

F32 = dict(dtype="float32", kv_cache_dtype="float32")
BF16_REL = 0.05  # bf16: max |diff| <= 5% of max |logit|
CPU = "cpu"
#: the three recurrent models: (registry arch, config overrides)
MODELS = {"hybrid": ("zamba2-2.7b", {}), "rwkv": ("rwkv6-7b", {}),
          "ssm": ("zamba2-2.7b", {"family": "ssm"})}


def t(a):
    """A reference array as a CPU tensor, bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def n(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x, dtype=np.float32)


def load_tree(module, tree):
    """Copy a reference parameter dict into a port module by name."""
    with torch.no_grad():
        for key, val in tree.items():
            if isinstance(val, dict):
                load_tree(getattr(module, key), val)
            else:
                getattr(module, key).copy_(t(val))
    return module


def leaves(tree, prefix=""):
    """A nested tree as {dotted key: leaf}, keys sorted at every level."""
    out = {}
    for k in sorted(tree):
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(tree[k], dict):
            out.update(leaves(tree[k], key))
        else:
            out[key] = tree[k]
    return out


def bits(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().contiguous()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def configs(model, **over):
    arch, fam = MODELS[model]
    return (smoke_config(arch).replace(**fam, **over),
            rreg.smoke_config(arch).replace(**fam, **over))


# ===========================================================================
# linear attention
# ===========================================================================

def _scalar_inputs(rng, B, S, H, dk, dv, shared, state, decay=None):
    qk = (B, S, dk) if shared else (B, S, H, dk)
    q = rng.normal(size=qk).astype(np.float32)
    k = rng.normal(size=qk).astype(np.float32) * 0.5
    v = rng.normal(size=(B, S, H, dv)).astype(np.float32)
    ld = (np.full((B, S, H), decay, np.float32) if decay is not None
          else -rng.uniform(0.01, 1.0, size=(B, S, H)).astype(np.float32))
    s0 = rng.normal(size=(B, H, dk, dv)).astype(np.float32) if state else None
    return q, k, v, ld, s0


def _vector_inputs(rng, B, S, H, dk, dv, state):
    q = rng.normal(size=(B, S, H, dk)).astype(np.float32)
    k = rng.normal(size=(B, S, H, dk)).astype(np.float32) * 0.5
    v = rng.normal(size=(B, S, H, dv)).astype(np.float32)
    ld = -rng.uniform(0.0, 1.5, size=(B, S, H, dk)).astype(np.float32)  # some past the clamp
    u = rng.normal(size=(H, dk)).astype(np.float32) * 0.1
    s0 = rng.normal(size=(B, H, dk, dv)).astype(np.float32) if state else None
    return q, k, v, ld, u, s0


def _opt(x, f):
    return None if x is None else f(x)


def _scalar_steps(q, k, v, ld, s0):
    """The port's chunked scalar form replayed as single steps."""
    B, S, H, dv = v.shape
    dk = q.shape[-1]
    state = s0 if s0 is not None else torch.zeros((B, H, dk, dv))
    ys = []
    for s in range(S):
        qs = q[:, s] if q.dim() == 4 else q[:, s, None].expand(B, H, dk)
        ks = k[:, s] if k.dim() == 4 else k[:, s, None].expand(B, H, dk)
        y, state = la.step_scalar_decay(qs, ks, v[:, s], ld[:, s], state)
        ys.append(y)
    return torch.stack(ys, 1), state


def _numpy_oracle(q, k, v, ld, s0, u=None):
    """Either recurrence one token at a time in float64 (``u`` given: the
    vector form, its log decay clamped)."""
    B, S, H, dv = v.shape
    q, k = (np.broadcast_to(a[:, :, None], (B, S, H, a.shape[-1])) if a.ndim == 3 else a
            for a in (q, k))
    state = np.zeros((B, H, q.shape[-1], dv)) if s0 is None else s0.astype(np.float64)
    ys = []
    for s in range(S):
        kv = np.einsum("bhk,bhv->bhkv", k[:, s], v[:, s]).astype(np.float64)
        if u is None:
            state = state * np.exp(ld[:, s].astype(np.float64))[..., None, None] + kv
            ys.append(np.einsum("bhk,bhkv->bhv", q[:, s], state))
        else:
            ys.append(np.einsum("bhk,bhkv->bhv", q[:, s], state + u[None, :, :, None] * kv))
            w = np.exp(np.clip(ld[:, s].astype(np.float64), -la.LOG_CLAMP, 0.0))
            state = state * w[..., None] + kv
    return np.stack(ys, 1), state


def _hold(got, want, oracle):
    """The port against the reference, float32 to 1e-5 of the largest
    value (both compute the chunk form, in other summation orders), and
    against the float64 oracle no further than twice the reference is."""
    for g, w, o in zip(got, want, oracle):
        g, w = n(g), np.asarray(w)
        scale = np.abs(o).max()
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * scale)
        assert np.abs(g - o).max() <= 2 * np.abs(w - o).max() + 1e-6 * scale


@pytest.mark.parametrize("S,chunk", [(96, 64), (130, 64), (128, 32), (20, 64), (64, 16)])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("state", [False, True])
def test_chunked_scalar_decay_matches_reference_and_steps(S, chunk, shared, state):
    rng = np.random.default_rng(S + chunk)
    q, k, v, ld, s0 = _scalar_inputs(rng, 2, S, 3, 8, 5, shared, state)
    y, st = la.chunked_scalar_decay(t(q), t(k), t(v), t(ld), _opt(s0, t), chunk=chunk)
    ry, rst = rla.chunked_scalar_decay(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(ld), _opt(s0, jnp.asarray), chunk=chunk)
    _hold((y, st), (ry, rst), _numpy_oracle(q, k, v, ld, s0))
    ys, sts = _scalar_steps(t(q), t(k), t(v), t(ld), _opt(s0, t))
    torch.testing.assert_close(y, ys, rtol=1e-5, atol=1e-5 * float(ys.abs().max()))
    torch.testing.assert_close(st, sts, rtol=1e-5, atol=1e-5 * float(sts.abs().max()))
    assert y.dtype == torch.float32 and st.dtype == torch.float32


@pytest.mark.parametrize("S,chunk", [(96, 32), (90, 32), (20, 32), (64, 16), (33, 32)])
@pytest.mark.parametrize("state", [False, True])
def test_chunked_vector_decay_matches_reference_and_steps(S, chunk, state):
    rng = np.random.default_rng(S * chunk)
    q, k, v, ld, u, s0 = _vector_inputs(rng, 2, S, 3, 8, 5, state)
    y, st = la.chunked_vector_decay(t(q), t(k), t(v), t(ld), t(u), _opt(s0, t), chunk=chunk)
    ry, rst = rla.chunked_vector_decay(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(ld), jnp.asarray(u), _opt(s0, jnp.asarray),
                                       chunk=chunk)
    _hold((y, st), (ry, rst), _numpy_oracle(q, k, v, ld, s0, u))
    state_t = t(s0) if state else torch.zeros((2, 3, 8, 5))
    ys = []
    for s in range(S):
        yy, state_t = la.step_vector_decay(t(q[:, s]), t(k[:, s]), t(v[:, s]), t(ld[:, s]),
                                           t(u), state_t)
        ys.append(yy)
    ys = torch.stack(ys, 1)
    torch.testing.assert_close(y, ys, rtol=1e-5, atol=1e-5 * float(ys.abs().max()))
    torch.testing.assert_close(st, state_t, rtol=1e-5, atol=1e-5 * float(state_t.abs().max()))


def test_step_forms_match_reference_and_keep_dtypes():
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(2, 3, 8)).astype(np.float32) for _ in range(3))
    ld = -rng.uniform(0, 2, size=(2, 3)).astype(np.float32)
    s0 = rng.normal(size=(2, 3, 8, 8)).astype(np.float32)
    y, st = la.step_scalar_decay(t(q), t(k), t(v), t(ld), t(s0))
    ry, rst = rla.step_scalar_decay(*(jnp.asarray(a) for a in (q, k, v, ld, s0)))
    np.testing.assert_allclose(n(y), np.asarray(ry), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(st), np.asarray(rst), rtol=1e-5, atol=1e-5)
    ldv = -rng.uniform(0, 2, size=(2, 3, 8)).astype(np.float32)
    u = rng.normal(size=(3, 8)).astype(np.float32)
    y, st = la.step_vector_decay(t(q), t(k), t(v), t(ldv), t(u), t(s0))
    ry, rst = rla.step_vector_decay(*(jnp.asarray(a) for a in (q, k, v, ldv, u, s0)))
    np.testing.assert_allclose(n(y), np.asarray(ry), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(st), np.asarray(rst), rtol=1e-5, atol=1e-5)
    # bf16 in, bf16 y out; the state stays float32
    y, st = la.chunked_scalar_decay(t(q[:, None]).bfloat16().expand(2, 4, 3, 8),
                                    t(k[:, None]).bfloat16().expand(2, 4, 3, 8),
                                    t(v[:, None]).bfloat16().expand(2, 4, 3, 8),
                                    t(ld[:, None]).expand(2, 4, 3))
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    assert la.LOG_CLAMP == rla.LOG_CLAMP and la.VEC_CHUNK == rla.VEC_CHUNK
    assert la.SCALAR_CHUNK == rla.SCALAR_CHUNK


def test_the_split_the_reference_asserts_raises():
    """S = 130 at chunk 32: 4 chunks do not divide it."""
    rng = np.random.default_rng(4)
    q, k, v, ld, u, _ = _vector_inputs(rng, 1, 130, 2, 4, 4, False)
    with pytest.raises(ValueError, match="4 must divide 130"):
        la.chunked_vector_decay(t(q), t(k), t(v), t(ld), t(u))
    with pytest.raises(AssertionError):
        rla.chunked_vector_decay(*(jnp.asarray(a) for a in (q, k, v, ld, u)))
    with pytest.raises(ValueError, match="must divide"):
        la.chunked_scalar_decay(t(q), t(k), t(v), t(ld[..., 0]), chunk=32)
    assert la._chunks(96, 64) == (1, 96) and la._chunks(130, 64) == (2, 65)


def _loss_weights(rng, B, S, H, dk, dv):
    return (rng.normal(size=(B, S, H, dv)).astype(np.float32),
            rng.normal(size=(B, H, dk, dv)).astype(np.float32))


def _port_grads(fn, inputs, wy, ws):
    xs = [t(a).requires_grad_(True) for a in inputs]
    y, st = fn(*xs)
    loss = (y * t(wy)).sum() + (st * t(ws)).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, xs)]


def _ref_grads(fn, inputs, wy, ws):
    def loss(*xs):
        y, st = fn(*xs)
        return jnp.sum(y * wy) + jnp.sum(st * ws)

    return [np.asarray(g) for g in jax.grad(loss, argnums=tuple(range(len(inputs))))(
        *(jnp.asarray(a) for a in inputs))]


@pytest.mark.parametrize("shared", [True, False])
def test_scalar_gradients_match_jax_grad(shared):
    rng = np.random.default_rng(11)
    q, k, v, ld, s0 = _scalar_inputs(rng, 2, 96, 3, 8, 5, shared, True)
    wy, ws = _loss_weights(rng, 2, 96, 3, 8, 5)
    got = _port_grads(lambda *a: la.chunked_scalar_decay(*a, chunk=32), (q, k, v, ld, s0), wy, ws)
    want = _ref_grads(lambda *a: rla.chunked_scalar_decay(*a, chunk=32), (q, k, v, ld, s0), wy,
                      ws)
    for g, w in zip(got, want):
        assert np.isfinite(w).all()
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


def test_vector_gradients_match_jax_grad():
    rng = np.random.default_rng(12)
    q, k, v, ld, u, s0 = _vector_inputs(rng, 2, 64, 3, 8, 5, True)
    ld = np.maximum(ld, -1.1)  # inside the clamp: the clip's gradient is 1 everywhere
    wy, ws = _loss_weights(rng, 2, 64, 3, 8, 5)
    got = _port_grads(la.chunked_vector_decay, (q, k, v, ld, u, s0), wy, ws)
    want = _ref_grads(rla.chunked_vector_decay, (q, k, v, ld, u, s0), wy, ws)
    for g, w in zip(got, want):
        assert np.isfinite(w).all()
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


def _oracle64(q, k, v, ld):
    """The scalar-decay recurrence one token at a time, float64."""
    B, S, H, dv = v.shape
    state = torch.zeros((B, H, q.shape[-1], dv), dtype=torch.float64)
    ys = []
    for s in range(S):
        state = state * torch.exp(ld[:, s])[..., None, None] + torch.einsum(
            "bhk,bhv->bhkv", k[:, s], v[:, s])
        ys.append(torch.einsum("bhk,bhkv->bhv", q[:, s], state))
    return torch.stack(ys, 1), state


@pytest.mark.parametrize("decay,ref_nan", [(-1.5, True), (-0.5, False)])
def test_large_decay_gradient_is_finite_where_the_reference_is_nan(decay, ref_nan):
    """B, S, H, dk, dv = 1, 64, 2, 4, 4: one chunk whose cumulative log
    decay reaches 64 x 1.5 = 96 > 88.7.  The reference exponentiates the
    masked-out upper triangle, which overflows; its gradients of q, k and
    the log decay are NaN.  The port's are finite and equal a float64
    sequential oracle's."""
    rng = np.random.default_rng(13)
    q, k, v, ld, _ = _scalar_inputs(rng, 1, 64, 2, 4, 4, False, False, decay=decay)
    wy, ws = _loss_weights(rng, 1, 64, 2, 4, 4)
    want = _ref_grads(rla.chunked_scalar_decay, (q, k, v, ld), wy, ws)
    assert [bool(np.isnan(g).any()) for g in want] == [ref_nan, ref_nan, False, ref_nan]
    got = _port_grads(la.chunked_scalar_decay, (q, k, v, ld), wy, ws)
    xs = [torch.from_numpy(a).double().requires_grad_(True) for a in (q, k, v, ld)]
    y, st = _oracle64(*xs)
    loss = (y * torch.from_numpy(wy).double()).sum() + (st * torch.from_numpy(ws).double()).sum()
    oracle = [g.numpy() for g in torch.autograd.grad(loss, xs)]
    for g, o in zip(got, oracle):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, o, rtol=1e-4, atol=1e-4)
    # the forward is the reference's wherever it keeps an entry
    y, st = la.chunked_scalar_decay(t(q), t(k), t(v), t(ld))
    ry, rst = rla.chunked_scalar_decay(*(jnp.asarray(a) for a in (q, k, v, ld)))
    np.testing.assert_allclose(n(y), np.asarray(ry), rtol=1e-5, atol=1e-5)


# ===========================================================================
# blocks
# ===========================================================================

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches(dtype):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 17, 24)).astype(np.float32)
    w = (rng.normal(size=(4, 24)) * 0.2).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    got = n(blocks._causal_conv(t(x).to(tdt), t(w).to(tdt), t(b).to(tdt)))
    want = np.asarray(rblocks._causal_conv(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                                           jnp.asarray(b, jdt)), np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(got - want).max() <= BF16_REL * np.abs(want).max()


def _block_pair(kind, dtype):
    model = "rwkv" if kind == "rwkv" else "ssm"
    cfg, rcfg = configs(model, dtype=dtype)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    if kind == "rwkv":
        rp = rblocks.init_rwkv6_block(jax.random.PRNGKey(7), rcfg, jdt)
        p = load_tree(blocks.RWKV6Block(cfg, tdt, CPU), rp)
        assert p.rwkv.u.dtype == p.rwkv.w0.dtype == torch.float32
    else:
        rp = rblocks.init_mamba2_block(jax.random.PRNGKey(7), rcfg, jdt)
        # a non-trivial decay and skip, so each parameter shows in the output
        rp["ssm"] = dict(rp["ssm"], A_log=jnp.linspace(-1.0, 1.0, rp["ssm"]["A_log"].shape[0]),
                         dt_bias=jnp.linspace(-0.5, 0.5, rp["ssm"]["dt_bias"].shape[0]))
        p = load_tree(blocks.Mamba2Block(cfg, tdt, CPU), rp)
        assert p.ssm.A_log.dtype == p.ssm.dt_bias.dtype == p.ssm.skip_D.dtype == torch.float32
    return cfg, rcfg, p, rp, jdt, tdt


def _block_fns(kind):
    if kind == "rwkv":
        return blocks.rwkv6_block, blocks.rwkv6_block_decode, rblocks.rwkv6_block, \
            rblocks.rwkv6_block_decode
    return blocks.mamba2_block, blocks.mamba2_block_decode, rblocks.mamba2_block, \
        rblocks.mamba2_block_decode


def _zero_states(kind, cfg, B):
    if kind == "rwkv":
        H, hd = blocks._rwkv_dims(cfg)
        return [np.zeros((B, cfg.d_model), np.float32), np.zeros((B, cfg.d_model), np.float32),
                np.zeros((B, H, hd, hd), np.float32)]
    d_inner, H, ds, conv_ch = blocks._mamba_dims(cfg)
    return [np.zeros((B, cfg.ssm_conv_width - 1, conv_ch), np.float32),
            np.zeros((B, H, ds, cfg.ssm_head_dim), np.float32)]


@pytest.mark.parametrize("kind", ["mamba2", "rwkv"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blocks_and_their_decode_match(kind, dtype):
    """The full-sequence block and 12 decode steps (states carried, in
    both packages) against the reference; at float32 the port's decode
    steps also equal its own full-sequence block."""
    cfg, rcfg, p, rp, jdt, tdt = _block_pair(kind, dtype)
    block, decode, rblock, rdecode = _block_fns(kind)
    rblock, rdecode = (jax.jit(f, static_argnums=2) for f in (rblock, rdecode))
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    xt, xj = t(x).to(tdt), jnp.asarray(x, jdt)
    with torch.no_grad():
        y, (aux, _) = block(p, xt, cfg)
    ry, (raux, _) = rblock(rp, xj, rcfg)
    assert y.dtype == tdt and float(aux) == float(raux) == 0.0
    # the recurrent state (4-D) is float32, the conv window and shifts the model's dtype
    states = [t(s).to(torch.float32 if s.ndim == 4 else tdt) for s in _zero_states(kind, cfg, 2)]
    rstates = [jnp.asarray(s, jnp.float32 if s.ndim == 4 else jdt)
               for s in _zero_states(kind, cfg, 2)]
    steps, rsteps = [], []
    with torch.no_grad():
        for s in range(12):
            o, states = decode(p, xt[:, s:s + 1], cfg, *states)
            ro, rstates = rdecode(rp, xj[:, s:s + 1], rcfg, *rstates)
            steps.append(o)
            rsteps.append(np.asarray(ro, np.float32))
    dec, rdec = n(torch.cat(steps, 1)), np.concatenate(rsteps, 1)
    if dtype == "float32":
        np.testing.assert_allclose(n(y), np.asarray(ry), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(dec, rdec, rtol=1e-5, atol=1e-5)
        for a, b in zip(states, rstates):
            np.testing.assert_allclose(n(a), np.asarray(b), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(dec, n(y), rtol=1e-4, atol=1e-4)
    else:
        ry = np.asarray(ry, np.float32)
        assert np.abs(n(y) - ry).max() <= BF16_REL * np.abs(ry).max()
        assert np.abs(dec - rdec).max() <= BF16_REL * np.abs(rdec).max()
        assert states[-1].dtype == torch.float32  # the recurrent state stays float32


def test_rwkv_block_carries_the_token_shift():
    """Two halves with the first half's shifts equal the whole sequence."""
    cfg, rcfg, p, rp, _, _ = _block_pair("rwkv", "float32")
    x = t(np.random.default_rng(10).normal(size=(2, 16, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        whole, (_, shifts) = blocks.rwkv6_block(p, x, cfg)
        first, (_, (st, sc)) = blocks.rwkv6_block(p, x[:, :8], cfg)
    _, (_, rshifts) = rblocks.rwkv6_block(rp, jnp.asarray(n(x)), rcfg)
    for a, b in zip(shifts, rshifts):
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(first, whole[:, :8])
    assert st.shape == sc.shape == (2, cfg.d_model)


# ===========================================================================
# the model: forward, decode, serving
# ===========================================================================

def _pair(model, **over):
    cfg, rcfg = configs(model, **over)
    rmodel = ref_build_model(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    m = build_model(cfg, device=CPU)
    m.load_state_dict(params_from_reference(cfg, rparams))
    return cfg, m, rmodel, rparams


#: forward's length: two Mamba2 chunks of 64, four RWKV6 chunks of 32
FWD_TOKENS = 128


def _run_both(model, steps=40, **over):
    """``forward`` over ``FWD_TOKENS`` tokens and ``steps`` decode steps
    over their first ``steps`` in both packages."""
    cfg, m, rmodel, rparams = _pair(model, **over)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             size=(2, FWD_TOKENS)).astype(np.int32)
    with torch.no_grad():
        fwd = n(m.forward(t(toks))[0])
    rfwd = np.asarray(jax.jit(rmodel.forward)(rparams, {"tokens": jnp.asarray(toks)})[0])
    cache, rcache = m.init_cache(2, 64), rmodel.init_cache(2, 64)
    dec = jax.jit(rmodel.decode_step)
    got, want = [], []
    with torch.no_grad():
        for step in range(steps):
            lg, cache = m.decode_step(cache, t(toks[:, step]), step)
            rlg, rcache = dec(rparams, rcache, jnp.asarray(toks[:, step]), jnp.int32(step))
            got.append(n(lg))
            want.append(np.asarray(rlg))
    return cfg, (fwd, rfwd), np.stack(got, 1), np.stack(want, 1), cache, rcache


@pytest.mark.parametrize("model", list(MODELS))
def test_model_float32_matches_reference(model):
    cfg, (fwd, rfwd), got, want, cache, rcache = _run_both(model, **F32)
    np.testing.assert_allclose(fwd, rfwd, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, fwd[:, :40], rtol=1e-4, atol=1e-4)  # decode = forward
    assert sorted(cache) == sorted(rcache)
    for key in rcache:
        assert cache[key].dtype == t(np.asarray(rcache[key])).dtype, key
        np.testing.assert_allclose(n(cache[key]), np.asarray(rcache[key]), rtol=1e-4, atol=1e-4,
                                   err_msg=key)


@pytest.mark.parametrize("model", list(MODELS))
def test_model_bf16_within_stated_bound(model):
    cfg, (fwd, rfwd), got, want, cache, rcache = _run_both(model, steps=24)
    assert cfg.dtype == "bfloat16"
    assert np.isfinite(fwd).all() and np.isfinite(got).all()
    assert np.abs(fwd - rfwd).max() <= BF16_REL * np.abs(rfwd).max()
    assert np.abs(got - want).max() <= BF16_REL * np.abs(want).max()
    state = cache["wkv" if model == "rwkv" else "ssm"]
    assert state.dtype == torch.float32
    assert cache["shift_t" if model == "rwkv" else "conv"].dtype == torch.bfloat16


@pytest.mark.parametrize("model", list(MODELS))
def test_serve_tokens_equal_the_reference(model):
    """4 requests through 2 slots: a slot's recurrent state (and the
    hybrid's shared K/V) carries over to its next request in both."""
    cfg, rcfg = configs(model, **F32)
    ref = rserve.ServeLoop(rcfg, 2, 64)
    loop = ServeLoop(cfg, 2, 64, device=CPU, params=params_from_reference(cfg, ref.params))
    rng = np.random.default_rng(4)
    prompts = [[int(x) for x in rng.integers(0, cfg.vocab_size, int(rng.integers(3, 8)))]
               for _ in range(4)]
    want = ref.run([rserve.Request(i, list(p), 5) for i, p in enumerate(prompts)])
    got = loop.run([Request(i, list(p), 5) for i, p in enumerate(prompts)])
    assert got == want and len(got) == 4


@pytest.mark.parametrize("model", list(MODELS))
def test_prefill_raises_in_both(model):
    cfg, m, rmodel, rparams = _pair(model, **F32)
    toks = np.zeros((1, 8), np.int32)
    with pytest.raises(NotImplementedError, match="decode drivers"):
        m.prefill(t(toks))
    with pytest.raises(NotImplementedError, match="decode drivers"):
        rmodel.prefill(rparams, {"tokens": jnp.asarray(toks)})


def test_hybrid_rejects_deferred_and_an_uneven_group():
    cfg, _ = configs("hybrid", **F32)
    m = build_model(cfg.replace(cache_update="deferred"), device=CPU).init(0)
    with pytest.raises(ValueError, match="deferred"):
        m.decode_step(m.init_cache(1, 8), torch.zeros(1, dtype=torch.long), 0)
    for bad in (dict(num_layers=5), dict(attn_every=3), dict(attn_every=0)):
        with pytest.raises(ValueError, match="multiple of attn_every"):
            build_model(cfg.replace(**bad), device=CPU)
    # the reference fails at its reshape
    rcfg = rreg.smoke_config("zamba2-2.7b").replace(num_layers=5)
    rmodel = ref_build_model(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    with pytest.raises(TypeError):
        rmodel.forward(rparams, {"tokens": jnp.zeros((1, 4), jnp.int32)})
    # the other caches take every update mode
    for mode in ("ring", "onehot"):
        m = build_model(cfg.replace(cache_update=mode), device=CPU).init(0)
        c = m.init_cache(1, 8)
        with torch.no_grad():
            lg, c = m.decode_step(c, torch.zeros(1, dtype=torch.long), 0)
        assert torch.isfinite(lg).all() and int(c["kpos"][0]) == 0


def test_cache_layouts_equal_the_reference():
    for model in MODELS:
        cfg, rcfg = configs(model)
        cache = build_model(cfg, device=CPU).init_cache(3, 40)
        rcache = ref_build_model(rcfg).init_cache(3, 40)
        assert sorted(cache) == sorted(rcache), model
        for key, val in rcache.items():
            assert tuple(cache[key].shape) == val.shape, (model, key)
            assert str(cache[key].dtype).split(".")[-1] == str(val.dtype), (model, key)
            np.testing.assert_array_equal(n(cache[key]), np.asarray(val, np.float32))


# ===========================================================================
# training
# ===========================================================================

def _train_both(tmp_path, model, seq_len, micro=1):
    """4 steps of each package's ``train()`` (float32, global batch 4)
    from the reference's step-0 checkpoint."""
    pcfg, rcfg = configs(model, dtype="float32", microbatches=micro)
    params = ref_build_model(rcfg).init(jax.random.PRNGKey(0))
    opt_cfg = ropt.AdamWConfig(moment_dtype=rcfg.opt_moment_dtype, total_steps=10)
    rckpt.save_checkpoint(str(tmp_path / "init"), 0, {"params": params,
                                                       "opt": ropt.init_opt_state(params, opt_cfg)})
    for who in ("ref", "port"):
        shutil.copytree(tmp_path / "init", tmp_path / who)
    kw = dict(steps=4, seq_len=seq_len, global_batch=4, ckpt_every=100)
    ref = rtrain.train(rcfg, ckpt_dir=str(tmp_path / "ref"), **kw)
    port = ptrain.train(pcfg, ckpt_dir=str(tmp_path / "port"), device=CPU, **kw)
    return pcfg, ref, port


#: the train slice's sequence: Mamba2 at 32 (one chunk, whose cumulative
#: log decay stays below the reference's overflow at 88.7), RWKV6 at 64
#: (two chunks of 32)
TRAIN_SEQ = {"hybrid": 32, "ssm": 32, "rwkv": 64}


@pytest.mark.parametrize("model,micro", [("hybrid", 1), ("hybrid", 2), ("rwkv", 1),
                                         ("rwkv", 2), ("ssm", 2)])
def test_train_is_the_references(tmp_path, model, micro):
    pcfg, ref, port = _train_both(tmp_path, model, TRAIN_SEQ[model], micro)
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=1e-5)
    trained = leaves(params_to_reference(pcfg, port["params"]))
    for k, v in leaves(ref["params"]).items():
        np.testing.assert_allclose(n(trained[k]), np.asarray(v), rtol=0, atol=1e-5, err_msg=k)


def test_hybrid_training_stays_finite_where_the_reference_goes_nan(tmp_path):
    """At seq 64 the smoke hybrid's cumulative log decay reaches 84 in a
    chunk at init and passes 88.7 within two updates: the reference's
    gradient turns NaN (``chunked_scalar_decay``'s overflow) and its loss
    with it; the port's losses stay finite and equal the reference's
    while the reference's are."""
    pcfg, ref, port = _train_both(tmp_path, "hybrid", 64)
    ref_losses, losses = np.asarray(ref["losses"]), np.asarray(port["losses"])
    assert np.isnan(ref_losses).any() and np.isfinite(losses).all()
    ok = np.isfinite(ref_losses)
    assert ok[0]
    np.testing.assert_allclose(losses[ok], ref_losses[ok], rtol=1e-5)
    assert all(torch.isfinite(p).all() for p in port["params"].values())


@pytest.mark.parametrize("model", ["hybrid", "rwkv"])
def test_remat_equals_no_remat(tmp_path, model):
    """The hybrid checkpoints a group (attn_every Mamba2 layers and the
    shared block), the others a layer: the same losses and parameters."""
    runs = []
    for remat in (False, True):
        cfg, _ = configs(model, dtype="float32", remat=remat)
        runs.append(ptrain.train(cfg, ckpt_dir=str(tmp_path / str(remat)), device=CPU,
                                 steps=2, seq_len=64, global_batch=2))
    np.testing.assert_allclose(runs[1]["losses"], runs[0]["losses"], rtol=1e-6)
    for k, v in runs[0]["params"].items():
        torch.testing.assert_close(runs[1]["params"][k], v, rtol=1e-6, atol=1e-7)


# ===========================================================================
# parameters, checkpoints, AdamW
# ===========================================================================

@pytest.mark.parametrize("model", list(MODELS))
def test_parameter_round_trip_and_order(model):
    cfg, rcfg = configs(model)
    rparams = ref_build_model(rcfg).init(jax.random.PRNGKey(1))
    mine = params_from_reference(cfg, rparams)
    m = build_model(cfg, device=CPU)
    assert set(mine) == set(m.state_dict())
    m.load_state_dict(mine)
    back = params_to_reference(cfg, m.state_dict())
    want = leaves(rparams)
    assert list(leaves(back)) == list(want)
    for k, v in want.items():
        assert str(leaves(back)[k].dtype).split(".")[-1] == str(v.dtype), k
        assert bits(leaves(back)[k]) == bits(v), k
    order = [_split_name(name)[::2] for name in reference_order(m.state_dict())]
    assert list(dict.fromkeys(ref for ref, _ in order)) == list(want)
    if model == "hybrid":
        assert "shared.attn.wq" in mine and mine["shared.attn.wq"].dim() == 2
        assert not hasattr(build_model(configs("ssm")[0], device=CPU), "shared")


def test_seeded_init_draws_the_references_distributions():
    for model in MODELS:
        cfg, _ = configs(model)
        a = build_model(cfg, device=CPU).init(seed=7).state_dict()
        b = build_model(cfg, device=CPU).init(seed=7).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a)
        assert all(torch.isfinite(v.float()).all() for v in a.values())
    cfg, _ = configs("rwkv")
    sd = build_model(cfg, device=CPU).init(seed=7).state_dict()
    assert torch.equal(sd["layers.0.rwkv.w0"], torch.full((cfg.d_model,), -2.0))
    assert torch.equal(sd["layers.0.rwkv.mu_ck"], torch.full((cfg.d_model,), 0.5,
                                                             dtype=torch.bfloat16))
    cfg, _ = configs("hybrid")
    sd = build_model(cfg, device=CPU).init(seed=7).state_dict()
    assert torch.equal(sd["layers.1.ssm.skip_D"], torch.ones(8))
    assert torch.equal(sd["layers.1.ssm.A_log"], torch.zeros(8))
    assert abs(float(sd["layers.0.ssm.conv_w"].float().std()) - 0.2) < 0.02


@pytest.mark.parametrize("model", ["hybrid", "rwkv"])
def test_checkpoints_round_trip_both_ways(tmp_path, model):
    """A bf16 training tree with float32 leaves inside it, written by the
    reference, read and written back by the port, read by the reference:
    every leaf bit-equal."""
    pcfg, rcfg = configs(model)
    params = ref_build_model(rcfg).init(jax.random.PRNGKey(2))
    rng = np.random.default_rng(8)
    opt = {"mu": jax.tree.map(lambda m: rng.normal(size=m.shape).astype(np.float32), params),
           "nu": jax.tree.map(lambda m: rng.random(size=m.shape).astype(np.float32), params),
           "step": np.int32(5)}
    state = {"params": params, "opt": opt}
    rckpt.save_checkpoint(str(tmp_path / "ref"), 5, state)
    _, tree = pckpt.restore_checkpoint(str(tmp_path / "ref"))
    m = build_model(pcfg, device=CPU)
    pp, ps = pckpt.load_train_state(m, tree)
    f32 = "layers.0.rwkv.u" if model == "rwkv" else "layers.0.ssm.A_log"
    assert pp[f32].dtype == torch.float32 and pp["embed.vocab"].dtype == torch.bfloat16
    pckpt.save_checkpoint(str(tmp_path / "port"), 5, pckpt.train_state(m, pp, ps))
    _, rtree = rckpt.restore_checkpoint(str(tmp_path / "port"))
    want, got = rckpt._flatten(state), rckpt._flatten(rtree)
    assert sorted(got) == sorted(want)
    for k in want:
        assert str(np.asarray(got[k]).dtype) == str(np.asarray(want[k]).dtype), k
        assert bits(got[k]) == bits(want[k]), k


@pytest.mark.parametrize("model", list(MODELS))
def test_adamw_decays_as_the_stacked_tree(model):
    """Zero gradients, decay alone, three steps: every ``layers.*`` leaf
    decays (A_log, dt_bias, skip_D, w0, the mu_* and the norms are 2-D
    stacked); the hybrid's ``shared`` norms and ``final_norm`` do not."""
    pcfg, rcfg = configs(model, dtype="float32")
    params = ref_build_model(rcfg).init(jax.random.PRNGKey(3))
    # nonzero everywhere, so a decayed leaf moves
    params = jax.tree.map(lambda p: p + 0.5, params)
    grads = jax.tree.map(lambda p: np.zeros(p.shape, np.float32), params)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    rc, pc = ropt.AdamWConfig(**kw), popt.AdamWConfig(**kw)
    rp, rs = params, ropt.init_opt_state(params, rc)
    start = params_from_reference(pcfg, params)
    pp = {k: v.clone() for k, v in start.items()}
    ps, pg = popt.init_opt_state(pp, pc), params_from_reference(pcfg, grads)
    ref_update = jax.jit(ropt.adamw_update, static_argnums=3)
    for _ in range(3):
        rp, rs, _ = ref_update(rp, grads, rs, rc)
        pp, ps, _ = popt.adamw_update(pp, pg, ps, pc)
    want = leaves(rp)
    got = leaves(params_to_reference(pcfg, pp))
    for k, v in want.items():
        np.testing.assert_allclose(n(got[k]), np.asarray(v), rtol=1e-6, atol=1e-7, err_msg=k)
    still = {name for name, p in pp.items() if torch.equal(p, start[name])}
    want_still = {"final_norm"} | {name for name in pp if name.startswith("shared.")
                                   and name.endswith("norm")}
    assert still == want_still
    assert model != "hybrid" or {"shared.attn.norm", "shared.mlp.norm"} <= still


@pytest.fixture
def default_steps():
    """The CLIs install the process-wide deep-halo depth; put it back."""
    from repro_torch.halo.program import get_default_halo_steps, set_default_halo_steps

    before = get_default_halo_steps()
    yield
    set_default_halo_steps(before)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "rwkv6-7b"])
def test_clis_serve_and_train_the_recurrent_families(tmp_path, capsys, arch, default_steps):
    from repro_torch.launch import serve as pserve

    assert pserve.main(["--arch", arch, "--scale", "smoke", "--device", "cpu", "--requests", "3",
                        "--max-new", "4", "--no-comm-cache"]) == 0
    assert "served 3/3 requests, 12 tokens" in capsys.readouterr().out
    out = ptrain.main(["--arch", arch, "--scale", "smoke", "--device", "cpu", "--steps", "2",
                       "--seq-len", "32", "--global-batch", "2", "--no-comm-cache",
                       "--ckpt-dir", str(tmp_path / "ckpt")])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert f"family={smoke_config(arch).family}" in capsys.readouterr().out
