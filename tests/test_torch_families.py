"""The port's attention families (vlm, moe, encdec) and ``prefill``
against the JAX reference, on the CPU, at the smoke configs of
qwen2-vl-2b, mixtral-8x22b, grok-1-314b and seamless-m4t-large-v2.

* Layers: ``mrope`` to 1e-5 (the smoke's (2, 3, 3) sections and the
  full config's (16, 24, 24)); the frontend specs and
  ``random_frontend_batch``'s t/h/w ids equal to the reference's.
* MoE: ``moe_ffn`` output and ``aux`` to 1e-5 at float32, the routing
  (``gate_idx``, ``keep``, ``slot``) equal to the reference's formulas
  run on the reference's own probabilities, including a skewed router
  that overflows the capacity so both packages drop tokens; ``_top_k``'s
  ties broken as ``lax.top_k``'s; the group-size error.
* ``cross_attention`` and ``encode_kv`` to 1e-5.
* The model through ``params_from_reference``: float32 ``forward`` (32
  tokens: a whole MoE group) and 40 ``decode_step`` s to 1e-4 with equal
  greedy tokens, bf16 within 5% of the largest logit; the encoder-decoder
  decodes against ``encode`` + ``make_cross_cache`` in both packages.
* ``prefill``: last logits and K/V against the reference's, against the
  port's own ``forward`` and teacher-forced decode (MoE at group size 1,
  where nothing drops); encdec raises in both.
* ``ServeLoop`` tokens equal to the reference's (float32, slots reused).
* 4 steps of ``train()`` from the reference's step-0 checkpoint to
  rtol 1e-5 in both packages, then ``make_prefill_step`` on the trained
  weights.
* Parameter and checkpoint round trips (the float32 router inside a
  bf16 checkpoint, the encoder stacked on ``encoder_layers``), AdamW's
  decay of the new subtrees on the stacked tree, the gradient wire over
  a float32 leaf among bf16 ones, and both CLIs at smoke size.
"""

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from jax import lax

import repro.configs.registry as rreg
import repro.launch.serve as rserve
import repro.launch.train as rtrain
import repro.train.checkpoint as rckpt
import repro.train.optimizer as ropt
import repro.train.train_step as rstep
from repro.models import blocks as rblocks
from repro.models import frontends as rfront
from repro.models import layers as rlayers
from repro.models.model import build_model as ref_build_model

from repro_torch.comm import Communicator
from repro_torch.configs import ShapeConfig, get_config, smoke_config
from repro_torch.data import synthetic_batch
from repro_torch.launch import serve as pserve
from repro_torch.launch import train as ptrain
from repro_torch.launch.serve import Request, ServeLoop
from repro_torch.models import blocks, frontends, layers
from repro_torch.models.model import (
    PORTED_FAMILIES,
    _split_name,
    build_model,
    params_from_reference,
    params_to_reference,
    reference_order,
)
from repro_torch.train import GradWire, checkpoint as pckpt
from repro_torch.train import optimizer as popt
from repro_torch.train import train_step as pstep

ARCHS = ("qwen2-vl-2b", "mixtral-8x22b", "grok-1-314b", "seamless-m4t-large-v2")
F32 = dict(dtype="float32", kv_cache_dtype="float32")
BF16_REL = 0.05  # bf16: max |diff| <= 5% of max |logit|
CPU = "cpu"
RNG = np.random.default_rng(0)


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


# ===========================================================================
# M-RoPE and the frontend stubs
# ===========================================================================

@pytest.mark.parametrize("sections,hd", [((2, 3, 3), 16), ((16, 24, 24), 128)])
def test_mrope_matches(sections, hd):
    q = RNG.normal(size=(2, 9, 4, hd)).astype(np.float32)
    k = RNG.normal(size=(2, 9, 2, hd)).astype(np.float32)
    pos3 = RNG.integers(0, 300, size=(3, 2, 9)).astype(np.int32)
    for theta in (1e4, 1e6):
        got = layers.mrope(t(q), t(k), t(pos3), sections, theta)
        want = rlayers.mrope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos3), sections, theta)
        for a, b in zip(got, want):
            np.testing.assert_allclose(n(a), np.asarray(b), rtol=1e-5, atol=1e-5)
    # equal streams are plain RoPE
    pos = np.broadcast_to(pos3[0], (3, 2, 9))
    got = layers.mrope(t(q), t(k), t(np.ascontiguousarray(pos)), sections, 1e4)
    want = layers.rope(t(q), t(k), t(pos3[0]), 1e4)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch,seq", [("qwen2-vl-2b", 40), ("qwen2-vl-2b", 10),
                                      ("seamless-m4t-large-v2", 24), ("mixtral-8x22b", 8)])
def test_frontend_specs_and_random_batch(arch, seq):
    cfg, rcfg = smoke_config(arch), rreg.smoke_config(arch)
    for got, want in ((frontends.audio_frame_spec(cfg, 3, 7), rfront.audio_frame_spec(rcfg, 3, 7)),
                      (frontends.vision_patch_spec(cfg, 3), rfront.vision_patch_spec(rcfg, 3)),
                      (frontends.mrope_position_spec(3, seq), rfront.mrope_position_spec(3, seq))):
        assert tuple(got.shape) == tuple(want.shape)
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
    got = frontends.random_frontend_batch(cfg, torch.Generator().manual_seed(0), 3, seq)
    want = rfront.random_frontend_batch(rcfg, jax.random.PRNGKey(0), 3, seq)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert tuple(got[key].shape) == w.shape, key
        if key == "positions":
            assert got[key].dtype == torch.int32
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(w))
        else:
            assert got[key].dtype == torch.bfloat16
            assert abs(float(got[key].float().std()) - 0.02) < 0.004


# ===========================================================================
# MoE
# ===========================================================================

def _ref_routing(probs, cfg):
    """The reference ``moe_ffn``'s routing lines, on its probabilities."""
    B, nsb, gs, E = probs.shape
    K = cfg.experts_per_token
    cap = max(int(gs * K / E * cfg.moe_capacity_factor), 1)
    gate_vals, gate_idx = lax.top_k(probs, K)
    onehot = jax.nn.one_hot(gate_idx, E, dtype=jnp.float32)
    flat = onehot.reshape(B, nsb, gs * K, E)
    pos = (jnp.cumsum(flat, axis=2) - flat).reshape(B, nsb, gs, K, E)
    keep = (pos < cap) * onehot
    slot = jnp.einsum("bnske->bnsk", pos * keep).astype(jnp.int32)
    return gate_idx, keep, slot, cap


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "grok-1-314b"])
@pytest.mark.parametrize("skewed", [False, True])
def test_moe_ffn_and_routing_match(arch, skewed):
    cfg = smoke_config(arch).replace(**F32)
    rcfg = rreg.smoke_config(arch).replace(**F32)
    rp = rblocks.init_moe_block(jax.random.PRNGKey(1), rcfg, jnp.float32)["moe"]
    x = RNG.normal(size=(2, 64, cfg.d_model)).astype(np.float32)
    if skewed:  # every token's first choice is expert 0: it overflows its capacity
        x = x + 1.0
        rp = dict(rp, router=rp["router"].at[:, 0].add(0.5))
    p = load_tree(blocks.MoE(cfg, torch.float32, CPU), rp)
    assert p.router.dtype == torch.float32
    y, aux = blocks.moe_ffn(p, t(x), cfg)
    ry, raux = rblocks.moe_ffn(rp, jnp.asarray(x), rcfg)
    np.testing.assert_allclose(n(y), np.asarray(ry), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-6)

    r = blocks.moe_route(p, t(x), cfg)
    gs = min(cfg.moe_group_size, 64)
    xg = jnp.asarray(x).reshape(2, 64 // gs, gs, -1)
    probs = jax.nn.softmax(jnp.einsum("bnsd,de->bnse", xg, rp["router"]), axis=-1)
    gate_idx, keep, slot, cap = _ref_routing(probs, rcfg)
    assert r["cap"] == cap
    np.testing.assert_array_equal(r["gate_idx"].numpy(), np.asarray(gate_idx))
    np.testing.assert_array_equal(r["keep"].numpy(), np.asarray(keep))
    np.testing.assert_array_equal(r["slot"].numpy(), np.asarray(slot))
    kept = int(r["keep"].sum())
    routed = 2 * 64 * cfg.experts_per_token
    if skewed:
        assert kept < routed  # tokens were dropped, in both packages
        assert int(r["keep"][..., 0].sum()) == 2 * (64 // gs) * cap
    # each kept (token, choice) has a slot of its own in its expert
    d = r["dispatch"]
    assert float(d.sum()) == kept and float(d.sum(dim=2).max()) <= 1.0


def test_top_k_breaks_ties_as_lax_top_k():
    x = np.array([[0.25, 0.5, 0.25, 0.5, 0.0], [0.2, 0.2, 0.2, 0.2, 0.2]], np.float32)
    vals, idx = blocks._top_k(t(x), 3)
    rvals, ridx = lax.top_k(jnp.asarray(x), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(rvals))


def test_moe_group_size_must_divide_the_sequence():
    cfg = smoke_config("mixtral-8x22b").replace(**F32)
    p = blocks.init_moe_block(torch.Generator().manual_seed(0), cfg, torch.float32).moe
    with pytest.raises(ValueError, match="multiple of the group size"):
        blocks.moe_ffn(p, torch.zeros((1, 40, cfg.d_model)), cfg)  # gs = min(32, 40)
    y, _ = blocks.moe_ffn(p, torch.zeros((1, 24, cfg.d_model)), cfg)  # gs = 24
    assert y.shape == (1, 24, cfg.d_model)


# ===========================================================================
# cross-attention
# ===========================================================================

def test_cross_attention_and_encode_kv_match():
    cfg = smoke_config("seamless-m4t-large-v2").replace(**F32)
    rcfg = rreg.smoke_config("seamless-m4t-large-v2").replace(**F32)
    rp = rblocks.init_cross_attention(jax.random.PRNGKey(2), rcfg, jnp.float32)
    p = load_tree(blocks.CrossAttention(cfg, torch.float32, CPU), rp)
    enc = RNG.normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    x = RNG.normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    kv = blocks.encode_kv(p, t(enc), cfg)
    rkv = rblocks.encode_kv(rp, jnp.asarray(enc), rcfg)
    for a, b in zip(kv, rkv):
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=1e-5, atol=1e-5)
    got = blocks.cross_attention(p, t(x), cfg, kv)
    want = rblocks.cross_attention(rp, jnp.asarray(x), rcfg, rkv)
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-5, atol=1e-5)


# ===========================================================================
# the model: forward, decode, prefill, encode
# ===========================================================================

def _pair(arch, **over):
    cfg = smoke_config(arch).replace(**over)
    rcfg = rreg.smoke_config(arch).replace(**over)
    rmodel = ref_build_model(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    model = build_model(cfg, device=CPU)
    model.load_state_dict(params_from_reference(cfg, rparams))
    return cfg, model, rmodel, rparams


def _frontend(cfg, B, S_enc=24, seed=3):
    """Seeded stub embeddings for both packages: (port kwargs, reference batch entries)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        pe = (rng.normal(size=(B, cfg.num_patches, cfg.d_model)) * 0.02).astype(np.float32)
        return {"patch_embeds": t(pe)}, {"patch_embeds": jnp.asarray(pe)}
    if cfg.family == "encdec":
        ee = (rng.normal(size=(B, S_enc, cfg.d_model)) * 0.02).astype(np.float32)
        return {"enc_embeds": t(ee)}, {"enc_embeds": jnp.asarray(ee)}
    return {}, {}


def _run_both(arch, steps=40, **over):
    """forward on 32 tokens and ``steps`` decode steps in both packages
    (the encoder-decoder's cross cache from ``encode`` of the same
    embeddings); the port's MoE routing of each is recorded."""
    cfg, model, rmodel, rparams = _pair(arch, **over)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(2, steps)).astype(
        np.int32)
    kw, rkw = _frontend(cfg, 2)
    with torch.no_grad(), blocks.recording_routes() as fwd_routes:
        fwd = n(model.forward(t(toks[:, :32]), **kw)[0])
    rfwd = np.asarray(jax.jit(rmodel.forward)(rparams, {"tokens": jnp.asarray(toks[:, :32]),
                                                        **rkw})[0])
    cache, rcache = model.init_cache(2, 64, enc_len=24), rmodel.init_cache(2, 64, enc_len=24)
    if cfg.family == "encdec":
        with torch.no_grad():
            cache["xk"], cache["xv"] = model.make_cross_cache(model.encode(kw["enc_embeds"]))
        rcache["xk"], rcache["xv"] = rmodel.make_cross_cache(
            rparams, rmodel.encode(rparams, rkw["enc_embeds"]))
    dec = jax.jit(rmodel.decode_step)
    got, want = [], []
    with torch.no_grad(), blocks.recording_routes() as dec_routes:
        for step in range(steps):
            lg, cache = model.decode_step(cache, t(toks[:, step]), step)
            rlg, rcache = dec(rparams, rcache, jnp.asarray(toks[:, step]), jnp.int32(step))
            got.append(n(lg))
            want.append(np.asarray(rlg))
    routes = {"forward": fwd_routes, "decode": dec_routes, "toks": toks, "rmodel": rmodel,
              "rparams": rparams}
    return cfg, (fwd, rfwd), np.stack(got, 1), np.stack(want, 1), cache, rcache, routes


@pytest.mark.parametrize("arch", ARCHS)
def test_model_float32_matches_reference(arch):
    cfg, (fwd, rfwd), got, want, cache, rcache, _ = _run_both(arch, **F32)
    np.testing.assert_allclose(fwd, rfwd, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))
    for key in rcache:
        np.testing.assert_allclose(n(cache[key]), np.asarray(rcache[key]), rtol=1e-4, atol=1e-4,
                                   err_msg=key)
    assert sorted(cache) == sorted(rcache)
    if cfg.sliding_window:
        assert cache["k"].shape[2] == 32  # mixtral's ring wrapped: 40 steps in 32 slots


#: a top-K choice whose probability is within this of the next expert's
#: is a near-tie: bf16 rounding of the router's input (2^-9 relative)
#: can flip it, and a flipped expert changes the token, and through
#: attention and the capacity count the row's later tokens, by O(1)
TIE = 5e-3


def _port_experts(routes, B, steps=None):
    """The port's recorded routing as (layers, B, S, K) sorted expert ids:
    a forward's records (one a layer) or ``steps`` decode steps' (one a
    layer a step)."""
    idx = [np.sort(r["gate_idx"].reshape(B, -1, r["gate_idx"].shape[-1]).numpy(), -1)
           for r in routes]
    if steps is None:
        return np.stack(idx)
    L = len(idx) // steps
    return np.stack([np.concatenate(idx[l::L], axis=1) for l in range(L)])


def _ref_recorded(monkeypatch, rmodel, rparams, toks, steps):
    """The reference's forward over ``toks[:, :32]`` and ``steps``
    teacher-forced decode steps, jitted, with its ``moe_ffn`` wrapped to
    hand each call's experts (sorted) and top-K margin, by its own
    routing lines, to the host (``jax.debug.callback``).  Returns the
    logits and the records as (layers, B, S, K) and (layers, B, S)."""
    cfg = rmodel.cfg
    K, rec = cfg.experts_per_token, []
    inner = rblocks.moe_ffn

    def record(idx, probs):
        top = np.sort(np.asarray(probs), -1)[..., ::-1]
        B = idx.shape[0]
        rec.append((np.sort(np.asarray(idx), -1).reshape(B, -1, K),
                    (top[..., K - 1] - top[..., K]).reshape(B, -1)))

    def moe_ffn(p, x, c):
        B, S, D = x.shape
        gs = min(c.moe_group_size, S)
        logits = jnp.einsum("bnsd,de->bnse", x.reshape(B, S // gs, gs, D).astype(jnp.float32),
                            p["router"])
        probs = jax.nn.softmax(logits, axis=-1)
        jax.debug.callback(record, _ref_routing(probs, c)[0], probs, ordered=True)
        return inner(p, x, c)

    monkeypatch.setattr(rblocks, "moe_ffn", moe_ffn)
    L = cfg.num_layers
    fwd = np.asarray(jax.jit(rmodel.forward)(rparams, {"tokens": jnp.asarray(toks[:, :32])})[0])
    step_fn = jax.jit(rmodel.decode_step)
    cache, dec = rmodel.init_cache(toks.shape[0], 64), []
    for step in range(steps):
        lg, cache = step_fn(rparams, cache, jnp.asarray(toks[:, step]), jnp.int32(step))
        dec.append(np.asarray(lg))
    jax.effects_barrier()
    fwd_rec, dec_rec = rec[:L], rec[L:]
    assert len(dec_rec) == L * steps
    stack = lambda rs, i: np.stack([r[i] for r in rs])  # noqa: E731
    dec_idx = np.stack([np.concatenate([r[0] for r in dec_rec[l::L]], 1) for l in range(L)])
    dec_gap = np.stack([np.concatenate([r[1] for r in dec_rec[l::L]], 1) for l in range(L)])
    return fwd, np.stack(dec, 1), (stack(fwd_rec, 0), stack(fwd_rec, 1)), (dec_idx, dec_gap)


def _unflipped(mine, ref):
    """Per row, the positions before the first one routed to other
    experts than the reference's at any layer, and the reference's
    margins at each row's first flip (its earliest position, lowest
    layer there): later flips follow from it."""
    idx, gap = ref
    flipped = (mine != idx).any(-1)                             # (layers, B, S)
    ok = np.cumprod(~flipped.any(0), axis=1).astype(bool)       # (B, S)
    first = []
    for b in range(flipped.shape[1]):
        if not ok[b].all():
            s = int(ok[b].sum())
            first.append(gap[int(np.argmax(flipped[:, b, s])), b, s])
    return ok, np.asarray(first)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_bf16_within_stated_bound(arch, monkeypatch):
    """bf16 within 5% of the largest logit.  For MoE: each row's first
    routing decision that differs from the reference's is a near-tie
    (``TIE``) in the reference's own probabilities, and the logits agree
    within the bound on each row's positions before it (the reference's
    experts recorded from its jitted run)."""
    cfg, (fwd, rfwd), got, want, cache, _, routes = _run_both(arch, steps=24)
    assert cfg.dtype == "bfloat16" and cache["k"].dtype == torch.bfloat16
    assert np.isfinite(fwd).all() and np.isfinite(got).all()
    fwd_ok = np.ones(fwd.shape[:2], bool)
    dec_ok = np.ones(got.shape[:2], bool)
    if cfg.family == "moe":
        rfwd, want, ref_fwd, ref_dec = _ref_recorded(monkeypatch, routes["rmodel"],
                                                     routes["rparams"], routes["toks"], 24)
        fwd_ok, fwd_gaps = _unflipped(_port_experts(routes["forward"], 2), ref_fwd)
        dec_ok, dec_gaps = _unflipped(_port_experts(routes["decode"], 2, steps=24), ref_dec)
        assert (fwd_gaps < TIE).all() and (dec_gaps < TIE).all(), (fwd_gaps, dec_gaps)
        assert fwd_ok.any() and dec_ok.any()  # the check is not vacuous
    assert np.abs(fwd - rfwd)[fwd_ok].max() <= BF16_REL * np.abs(rfwd).max()
    assert np.abs(got - want)[dec_ok].max() <= BF16_REL * np.abs(want).max()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference_forward_and_decode(arch):
    cfg, model, rmodel, rparams = _pair(arch, **F32)
    S = 16
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, size=(2, S)).astype(np.int32)
    if cfg.family == "encdec":
        for fn in (lambda: model.prefill(t(toks)),
                   lambda: rmodel.prefill(rparams, {"tokens": jnp.asarray(toks)})):
            with pytest.raises(NotImplementedError, match="decode drivers"):
                fn()
        return
    kw, rkw = _frontend(cfg, 2)
    step = pstep.make_prefill_step(model)
    with torch.no_grad():
        for with_patches in ((False, True) if cfg.family == "vlm" else (False,)):
            batch = {"tokens": t(toks), **(kw if with_patches else {})}
            logits, cache = step(batch)
            rlogits, rcache = jax.jit(rstep.make_prefill_step(rmodel))(
                rparams, {"tokens": jnp.asarray(toks), **(rkw if with_patches else {})})
            np.testing.assert_allclose(n(logits), np.asarray(rlogits), rtol=1e-5, atol=1e-5)
            assert sorted(cache) == sorted(rcache) == ["k", "v"]
            for key in ("k", "v"):
                assert cache[key].shape == (cfg.num_layers, 2, S, cfg.num_kv_heads, cfg.hd)
                np.testing.assert_allclose(n(cache[key]), np.asarray(rcache[key]), rtol=1e-5,
                                           atol=1e-5)
            if cfg.family == "vlm":  # no patches: an empty (B, 0, D) prefix
                pe = kw["patch_embeds"] if with_patches else torch.zeros((2, 0, cfg.d_model))
                fwd, _ = model.forward(t(toks), patch_embeds=pe)
            else:
                fwd, _ = model.forward(t(toks))
            torch.testing.assert_close(logits, fwd[:, -1], rtol=1e-5, atol=1e-5)
        # the K/V that S teacher-forced decode steps write (MoE at group
        # size 1 in both, where no token drops)
        model.cfg = cfg.replace(moe_group_size=1)
        logits, cache = model.prefill(t(toks))
        dcache = model.init_cache(2, S)
        for s in range(S):
            lg, dcache = model.decode_step(dcache, t(toks[:, s]), s)
        torch.testing.assert_close(lg, logits, rtol=1e-4, atol=1e-4)
        for key in ("k", "v"):
            torch.testing.assert_close(dcache[key], cache[key], rtol=1e-4, atol=1e-4)


def test_decode_equals_forward_where_moe_drops_nothing():
    """Decode's groups are single tokens (capacity 1, no drops); forward's
    are ``moe_group_size`` tokens and drop over capacity.  At group size 1
    they agree; at the smoke's 32, a sequence of one repeated token routes
    every position alike, overflows two experts and differs."""
    cfg = smoke_config("mixtral-8x22b").replace(**F32)
    model = build_model(cfg, device=CPU).init(seed=4)
    rand = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 32)))
    same = torch.full((2, 32), 7)

    def decode(toks):
        cache, out = model.init_cache(2, 32), []
        for s in range(32):
            lg, cache = model.decode_step(cache, toks[:, s], s)
            out.append(lg)
        return torch.stack(out, 1)

    with torch.no_grad():
        model.cfg = cfg.replace(moe_group_size=1)
        for toks in (rand, same):
            torch.testing.assert_close(model.forward(toks)[0], decode(toks), rtol=1e-4,
                                       atol=1e-4)
        model.cfg = cfg
        h = blocks.attention(model.layers[0].attn, model._embed(same), cfg,
                             torch.arange(32).expand(2, 32))[0]
        r = blocks.moe_route(model.layers[0].moe, layers.rms_norm(
            h, model.layers[0].moe.norm, cfg.norm_eps), cfg)
        assert int(r["keep"].sum()) == 2 * 2 * r["cap"] < 2 * 32 * 2  # two experts at capacity
        assert not torch.allclose(model.forward(same)[0], decode(same), rtol=1e-3, atol=1e-3)


def test_encode_and_cross_cache_match():
    cfg, model, rmodel, rparams = _pair("seamless-m4t-large-v2", **F32)
    kw, rkw = _frontend(cfg, 2, S_enc=20)
    with torch.no_grad():
        enc = model.encode(kw["enc_embeds"])
        xk, xv = model.make_cross_cache(enc)
    renc = rmodel.encode(rparams, rkw["enc_embeds"])
    rxk, rxv = rmodel.make_cross_cache(rparams, renc)
    np.testing.assert_allclose(n(enc), np.asarray(renc), rtol=1e-5, atol=1e-5)
    for a, b in ((xk, rxk), (xv, rxv)):
        assert a.shape == (cfg.num_layers, 2, 20, cfg.num_kv_heads, cfg.hd)
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=1e-5, atol=1e-5)
    cache = model.init_cache(2, 64)
    assert cache["xk"].shape[2] == 64 and cache["xk"].dtype == torch.float32
    bf = build_model(smoke_config("seamless-m4t-large-v2").replace(kv_cache_dtype="float32"),
                     device=CPU).init_cache(1, 8, enc_len=5)
    assert bf["xk"].dtype == torch.bfloat16 and bf["k"].dtype == torch.float32  # model dtype
    with pytest.raises(ValueError, match="deferred"):
        m = build_model(cfg.replace(cache_update="deferred"), device=CPU).init(0)
        m.decode_step(m.init_cache(1, 8), torch.zeros(1, dtype=torch.long), 0)


# ===========================================================================
# serving and training
# ===========================================================================

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_tokens_equal_the_reference(arch):
    cfg = smoke_config(arch).replace(**F32)
    ref = rserve.ServeLoop(rreg.smoke_config(arch).replace(**F32), 2, 64)
    loop = ServeLoop(cfg, 2, 64, device=CPU, params=params_from_reference(cfg, ref.params))
    rng = np.random.default_rng(4)
    prompts = [[int(x) for x in rng.integers(0, cfg.vocab_size, int(rng.integers(3, 8)))]
               for _ in range(4)]  # 4 requests through 2 slots: slots are reused
    want = ref.run([rserve.Request(i, list(p), 5) for i, p in enumerate(prompts)])
    got = loop.run([Request(i, list(p), 5) for i, p in enumerate(prompts)])
    assert got == want and len(got) == 4


SLICE = dict(steps=4, seq_len=32, global_batch=4)


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "mixtral-8x22b", "seamless-m4t-large-v2"])
def test_train_is_the_references(tmp_path, arch):
    """4 steps of each package's ``train()`` from the reference's step-0
    checkpoint (float32), then ``make_prefill_step`` on the trained
    weights in both."""
    rcfg = rreg.smoke_config(arch).replace(dtype="float32")
    pcfg = smoke_config(arch).replace(dtype="float32")
    params = ref_build_model(rcfg).init(jax.random.PRNGKey(0))
    opt_cfg = ropt.AdamWConfig(moment_dtype=rcfg.opt_moment_dtype, total_steps=10)
    rckpt.save_checkpoint(str(tmp_path / "init"), 0, {"params": params,
                                                       "opt": ropt.init_opt_state(params, opt_cfg)})
    for who in ("ref", "port"):
        shutil.copytree(tmp_path / "init", tmp_path / who)
    ref = rtrain.train(rcfg, ckpt_dir=str(tmp_path / "ref"), ckpt_every=100, **SLICE)
    port = ptrain.train(pcfg, ckpt_dir=str(tmp_path / "port"), ckpt_every=100, device=CPU,
                        **SLICE)
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=1e-5)
    trained = params_to_reference(pcfg, port["params"])
    for k, v in leaves(ref["params"]).items():
        np.testing.assert_allclose(n(leaves(trained)[k]), np.asarray(v), rtol=0, atol=1e-4,
                                   err_msg=k)
    if pcfg.family == "encdec":
        return  # no prefill for the encoder-decoder
    toks = np.random.default_rng(7).integers(0, pcfg.vocab_size, (2, 16)).astype(np.int32)
    with torch.no_grad():
        logits, cache = pstep.make_prefill_step(port["model"])({"tokens": t(toks)})
    rlogits, rcache = rstep.make_prefill_step(ref_build_model(rcfg))(
        jax.tree.map(lambda v: jnp.asarray(n(v)), trained), {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(n(logits), np.asarray(rlogits), rtol=1e-5, atol=1e-5)
    # the cache is in the KV dtype, bf16: a float32 K a hair either side
    # of a rounding boundary lands one bf16 ulp (2^-7 relative at most) apart
    np.testing.assert_allclose(n(cache["k"]), np.asarray(rcache["k"]), rtol=2.0 ** -7,
                               atol=1e-5)


# ===========================================================================
# parameters, checkpoints, AdamW, the gradient wire
# ===========================================================================

@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_round_trip_and_order(arch):
    cfg = smoke_config(arch)
    rparams = ref_build_model(rreg.smoke_config(arch)).init(jax.random.PRNGKey(1))
    mine = params_from_reference(cfg, rparams)
    model = build_model(cfg, device=CPU)
    assert set(mine) == set(model.state_dict())
    model.load_state_dict(mine)
    back = params_to_reference(cfg, model.state_dict())
    want = leaves(rparams)
    assert list(leaves(back)) == list(want)
    for k, v in want.items():
        assert str(leaves(back)[k].dtype).split(".")[-1] == str(v.dtype), k
        assert bits(leaves(back)[k]) == bits(v), k
    # the trainable order is jax.tree.leaves' order, each stacked leaf's layers in turn
    order = [_split_name(name)[::2] for name in reference_order(model.state_dict())]
    assert list(dict.fromkeys(ref for ref, _ in order)) == list(want)
    assert order == sorted(order, key=lambda kl: (list(want).index(kl[0]), kl[1]))
    if cfg.family == "moe":
        assert model.layers[0].moe.router.dtype == torch.float32
        assert model.layers[0].moe.w_gate.dtype == torch.bfloat16
    if cfg.family == "encdec":
        assert len(model.encoder.layers) == 2 and len(model.xattn) == cfg.num_layers == 4


def test_seeded_init_and_ported_families():
    assert PORTED_FAMILIES == ("dense", "vlm", "moe", "encdec", "ssm", "rwkv", "hybrid")
    for arch in ARCHS:
        cfg = smoke_config(arch)
        a = build_model(cfg, device=CPU).init(seed=7).state_dict()
        b = build_model(cfg, device=CPU).init(seed=7).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a)
        assert all(torch.isfinite(v.float()).all() for v in a.values())
    cfg = smoke_config("seamless-m4t-large-v2")
    sd = build_model(cfg, device=CPU).init(seed=7).state_dict()
    assert torch.equal(sd["encoder.final_norm"], torch.ones(cfg.d_model, dtype=torch.bfloat16))
    # the draw order: embed, layers, final norm, head, encoder layers, xattn
    gen = torch.Generator().manual_seed(7)
    layers.init_dense(gen, cfg.vocab_size, cfg.d_model, torch.bfloat16)
    for _ in range(cfg.num_layers):
        blocks.init_dense_block(gen, cfg, torch.bfloat16)
    layers.init_dense(gen, cfg.d_model, cfg.vocab_size, torch.bfloat16)
    for _ in range(cfg.encoder_layers):
        blocks.init_dense_block(gen, cfg, torch.bfloat16)
    xa = blocks.init_cross_attention(gen, cfg, torch.bfloat16)
    assert torch.equal(xa.wq, sd["xattn.0.wq"])
    moe = smoke_config("mixtral-8x22b")
    blk = blocks.init_moe_block(torch.Generator().manual_seed(0), moe, torch.bfloat16)
    w = blk.moe.w_gate.float()
    assert abs(float(w.std()) * moe.d_model ** 0.5 - 1.0) < 0.05


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "seamless-m4t-large-v2", "qwen2-vl-2b"])
def test_checkpoints_round_trip_both_ways(tmp_path, arch):
    """A bf16 training tree (the MoE router float32 inside it; the encoder
    stacked on ``encoder_layers``) written by the reference, read and
    written back by the port, read by the reference: every leaf bit-equal."""
    rcfg, pcfg = rreg.smoke_config(arch), smoke_config(arch)
    params = ref_build_model(rcfg).init(jax.random.PRNGKey(2))
    rng = np.random.default_rng(8)
    opt = {"mu": jax.tree.map(lambda m: rng.normal(size=m.shape).astype(np.float32), params),
           "nu": jax.tree.map(lambda m: rng.random(size=m.shape).astype(np.float32), params),
           "step": np.int32(5)}
    state = {"params": params, "opt": opt}
    rckpt.save_checkpoint(str(tmp_path / "ref"), 5, state)
    _, tree = pckpt.restore_checkpoint(str(tmp_path / "ref"))
    model = build_model(pcfg, device=CPU)
    pp, ps = pckpt.load_train_state(model, tree)
    if pcfg.family == "moe":
        assert pp["layers.0.moe.router"].dtype == torch.float32
        assert pp["layers.0.moe.w_in"].dtype == torch.bfloat16
    pckpt.save_checkpoint(str(tmp_path / "port"), 5, pckpt.train_state(model, pp, ps))
    _, rtree = rckpt.restore_checkpoint(str(tmp_path / "port"))
    want = rckpt._flatten(state)
    got = rckpt._flatten(rtree)
    assert sorted(got) == sorted(want)
    for k in want:
        assert str(np.asarray(got[k]).dtype) == str(np.asarray(want[k]).dtype), k
        assert bits(got[k]) == bits(want[k]), k


def test_adamw_decays_the_new_subtrees_as_the_stacked_tree():
    """Zero gradients, decay alone, three steps: every leaf of a stacked
    subtree (``layers``, ``encoder.layers``, ``xattn``) decays, as its
    norms are 2-D in the reference's tree; ``final_norm`` and
    ``encoder.final_norm`` do not."""
    for arch in ("seamless-m4t-large-v2", "mixtral-8x22b"):
        rcfg = rreg.smoke_config(arch).replace(dtype="float32")
        pcfg = smoke_config(arch).replace(dtype="float32")
        params = ref_build_model(rcfg).init(jax.random.PRNGKey(3))
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
            np.testing.assert_allclose(n(got[k]), np.asarray(v), rtol=1e-6, atol=1e-7,
                                       err_msg=k)
        for name, p in pp.items():
            moved = not torch.equal(p, start[name])
            assert moved == (name not in ("final_norm", "encoder.final_norm")), name


def test_grad_wire_carries_a_float32_leaf_among_bf16():
    """The MoE router's float32 gradient between bf16 ones: the lossless
    wire returns every leaf bit-exact in its own dtype."""
    cfg = smoke_config("mixtral-8x22b")
    model = build_model(cfg, device=CPU).init(0)
    params = model.trainable()
    batch = synthetic_batch(cfg, ShapeConfig("train", 32, 2, "train"), 0, device=CPU)
    _, _, grads = pstep.make_grad_step(model, popt.AdamWConfig())[0](params, batch)
    assert grads["layers.0.moe.router"].dtype == torch.float32
    assert grads["layers.0.moe.w_gate"].dtype == torch.bfloat16
    for mode in ("rle", "auto"):
        out = GradWire(Communicator(device=CPU), mode=mode).exchange(grads)
        for k, g in grads.items():
            assert out[k].dtype == g.dtype and torch.equal(out[k], g), (mode, k)


@pytest.fixture
def default_steps():
    """The CLIs install the process-wide deep-halo depth; put it back."""
    from repro_torch.halo.program import get_default_halo_steps, set_default_halo_steps

    before = get_default_halo_steps()
    yield
    set_default_halo_steps(before)


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "seamless-m4t-large-v2", "mixtral-8x22b"])
def test_clis_serve_and_train_the_families(tmp_path, capsys, arch, default_steps):
    assert pserve.main(["--arch", arch, "--scale", "smoke", "--device", "cpu", "--requests", "3",
                        "--max-new", "4", "--no-comm-cache"]) == 0
    assert f"served 3/3 requests, 12 tokens" in capsys.readouterr().out
    out = ptrain.main(["--arch", arch, "--scale", "smoke", "--device", "cpu", "--steps", "2",
                       "--seq-len", "32", "--global-batch", "2", "--no-comm-cache",
                       "--ckpt-dir", str(tmp_path / "ckpt")])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert f"family={get_config(arch).family}" in capsys.readouterr().out
