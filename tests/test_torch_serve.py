"""The port's serving path against the JAX reference, on the CPU.

* Configs: every ``ARCHS`` entry and ``smoke_config``, ``param_count``,
  ``SHAPES`` and the derived properties equal the reference's; each of
  the ten configs builds at smoke size and runs a finite ``forward``.
* Layers at float32 to 1e-5: ``rms_norm``, ``rope``, ``decode_attention``
  (plain, ``kpos`` with a window, deferred ``current``), the
  ``flash_attention`` forward on ``tests/test_flash_attention.py``'s cases
  in both head layouts, ``ring_update`` and ``ring_update_stacked``.
* ``attention_decode`` under all four ``cache_update`` modes.
* The model: ``params_from_reference``, then ``forward`` and 40
  ``decode_step`` s for the four dense archs' smoke configs.  At float32
  (``dtype`` and ``kv_cache_dtype``) logits and caches agree to
  rtol = atol = 1e-4 and the greedy tokens are identical; at bf16, the
  configs' own dtype, the logits agree to 5% of the largest logit (bf16
  keeps 8 significant bits; the reference and torch round products and
  activations at different points).  h2o-danube's smoke window is 32, so
  its ring wraps within the 40 steps.
* ``ServeLoop``: the reference's three ``test_serve_loop.py`` cases, and
  token lists equal to the reference's at float32 with carried
  parameters, slot reuse included; the CLI at ``--scale smoke --device
  cpu``.

The reference runs eagerly or jitted on the CPU; the port on the CPU.
"""

import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import repro.configs.base as rbase
import repro.configs.registry as rreg
import repro.launch.serve as rserve
from repro.models import blocks as rblocks
from repro.models import layers as rlayers
from repro.models.model import build_model as ref_build_model

from repro_torch.configs import ARCH_IDS, ARCHS, SHAPES, get_config, shape_for, smoke_config
from repro_torch.launch import serve
from repro_torch.launch.serve import Request, ServeLoop
from repro_torch.models import blocks, layers
from repro_torch.models.model import Model, build_model, params_from_reference

DENSE = ("qwen2-0.5b", "h2o-danube-1.8b", "qwen3-32b", "yi-6b")
F32 = dict(dtype="float32", kv_cache_dtype="float32")
BF16_REL = 0.05  # bf16: max |diff| <= 5% of max |logit|
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


# ===========================================================================
# configs
# ===========================================================================

def test_configs_equal_the_reference():
    assert ARCH_IDS == rreg.ARCH_IDS
    for name in rreg.ARCHS:
        mine, ref = ARCHS[name], rreg.ARCHS[name]
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert dataclasses.asdict(smoke_config(name)) == dataclasses.asdict(
            rreg.smoke_config(name))
        for cfg, rcfg in ((mine, ref), (smoke_config(name), rreg.smoke_config(name))):
            assert cfg.param_count() == rcfg.param_count()
            assert cfg.param_count(active_only=True) == rcfg.param_count(active_only=True)
            assert (cfg.hd, cfg.attention_free, cfg.sub_quadratic) == (
                rcfg.hd, rcfg.attention_free, rcfg.sub_quadratic)
    assert [dataclasses.asdict(s) for s in SHAPES] == [
        dataclasses.asdict(s) for s in rbase.SHAPES]
    assert dataclasses.asdict(shape_for("decode_32k")) == dataclasses.asdict(
        rbase.shape_for("decode_32k"))
    with pytest.raises(KeyError):
        get_config("gpt-17")
    cfg = get_config("qwen2-0.5b")
    assert cfg.replace(dtype="float32").dtype == "float32"
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.d_ff,
            cfg.vocab_size, cfg.dtype, cfg.tie_embeddings) == (
        24, 896, 14, 2, 4864, 151936, "bfloat16", True)
    assert cfg.param_count() == 494_004_224


@pytest.mark.parametrize("name", ARCH_IDS)
def test_every_registry_config_builds_and_runs_a_finite_forward(name):
    """Each of the ten configs at smoke size on the CPU, weights from a
    seed: the model builds, and ``forward`` over 32 tokens (with the
    frontend stub's embeddings where the family takes them) gives finite
    logits of shape (B, S, V)."""
    from repro_torch.models.frontends import random_frontend_batch

    cfg = smoke_config(name)
    model = Model(cfg, device="cpu").init(seed=3)
    toks = torch.randint(0, cfg.vocab_size, (2, 32), generator=torch.Generator().manual_seed(4))
    stub = random_frontend_batch(cfg, torch.Generator().manual_seed(5), 2, 32)
    with torch.no_grad():
        logits, aux = model.forward(toks, stub.get("positions"),
                                    patch_embeds=stub.get("patch_embeds"),
                                    enc_embeds=stub.get("enc_embeds"))
    assert logits.shape == (2, 32, cfg.vocab_size) and logits.dtype == torch.float32
    assert torch.isfinite(logits).all() and torch.isfinite(aux)
    assert set(params_from_reference(cfg, {})) == set()


# ===========================================================================
# layers
# ===========================================================================

def test_rms_norm_and_rope_match():
    x = RNG.normal(size=(2, 5, 3, 16)).astype(np.float32)
    scale = RNG.normal(size=(16,)).astype(np.float32)
    np.testing.assert_allclose(
        n(layers.rms_norm(t(x), t(scale), 1e-6)),
        np.asarray(rlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6)),
        rtol=1e-5, atol=1e-5)
    q = RNG.normal(size=(2, 7, 4, 16)).astype(np.float32)
    k = RNG.normal(size=(2, 7, 2, 16)).astype(np.float32)
    pos = np.stack([np.arange(7), np.arange(100, 107)]).astype(np.int32)
    for theta in (1e4, 1e6, 5e6):
        got = layers.rope(t(q), t(k), t(pos), theta)
        want = rlayers.rope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos), theta)
        for a, b in zip(got, want):
            np.testing.assert_allclose(n(a), np.asarray(b), rtol=1e-5, atol=1e-5)


def _qkv(B, Sq, Sk, H, KVH, D):
    q = (RNG.normal(size=(B, Sq, H, D)) * 0.5).astype(np.float32)
    k = (RNG.normal(size=(B, Sk, KVH, D)) * 0.5).astype(np.float32)
    v = (RNG.normal(size=(B, Sk, KVH, D)) * 0.5).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("merged", [False, True])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 16), (False, None)])
@pytest.mark.parametrize("chunk", [8, 32, 64])
def test_flash_forward_matches(causal, window, chunk, merged):
    q, k, v = _qkv(2, 64, 64, 4, 2, 16)
    got = layers.flash_attention(t(q), t(k), t(v), causal=causal, window=window, chunk=chunk,
                                 merged=merged)
    want = rlayers.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   causal=causal, window=window, chunk=chunk)
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("merged", [False, True])
def test_flash_gqa_grouping_and_offset(merged):
    q, k, v = _qkv(2, 4, 20, 8, 2, 16)
    got = layers.flash_attention(t(q), t(k), t(v), causal=True, q_offset=16, chunk=5,
                                 merged=merged)
    want = rlayers.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   causal=True, q_offset=16, chunk=5)
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["plain", "kpos_window", "deferred"])
def test_decode_attention_matches(case):
    B, S, H, KVH, D = 2, 24, 8, 2, 16
    q, kc, vc = _qkv(B, 1, S, H, KVH, D)
    tpos = 19
    kw = {}
    tkw = {}
    if case != "plain":
        kpos = np.where(np.arange(S) < 20, np.arange(S) + 5, -1).astype(np.int32)
        kpos[3] = tpos  # a rolled slot holding the current position
        kw.update(kpos=jnp.asarray(kpos), window=9)
        tkw.update(kpos=t(kpos), window=9)
    if case == "deferred":
        kn = RNG.normal(size=(B, 1, KVH, D)).astype(np.float32)
        vn = RNG.normal(size=(B, 1, KVH, D)).astype(np.float32)
        kw["current"] = (jnp.asarray(kn), jnp.asarray(vn))
        tkw["current"] = (t(kn), t(vn))
    got = layers.decode_attention(t(q), t(kc), t(vc), tpos, **tkw)
    want = rlayers.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                    jnp.int32(tpos), **kw)
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_ring_update_matches():
    B, S, KV, HD, L = 4, 16, 2, 8, 3
    cache = RNG.normal(size=(B, S, KV, HD)).astype(np.float32)
    new = RNG.normal(size=(B, 1, KV, HD)).astype(np.float32)
    for slot in (0, 5, 15):
        got = layers.ring_update(t(cache), t(new), slot)
        want = rlayers.ring_update(jnp.asarray(cache), jnp.asarray(new), jnp.int32(slot))
        np.testing.assert_array_equal(n(got), np.asarray(want))
    c2 = RNG.normal(size=(L, B, S, KV, HD)).astype(np.float32)
    n2 = RNG.normal(size=(L, B, 1, KV, HD)).astype(np.float32)
    got = layers.ring_update_stacked(t(c2), t(n2), 9)
    want = rlayers.ring_update_stacked(jnp.asarray(c2), jnp.asarray(n2), jnp.int32(9))
    np.testing.assert_array_equal(n(got), np.asarray(want))
    # bf16 cache, float32 rows: cast on write
    cb = torch.zeros((B, S, KV, HD), dtype=torch.bfloat16)
    layers.ring_update(cb, t(new), 3)
    assert cb.dtype == torch.bfloat16 and torch.equal(cb[:, 3:4], t(new).to(torch.bfloat16))


def test_gated_mlp_and_init_helpers():
    x = RNG.normal(size=(2, 3, 16)).astype(np.float32)
    p = {k: RNG.normal(size=s).astype(np.float32)
         for k, s in (("w_gate", (16, 24)), ("w_in", (16, 24)), ("w_out", (24, 16)))}
    for act in ("silu", "gelu", "relu"):
        got = layers.gated_mlp(SimpleNamespace(**{k: t(v) for k, v in p.items()}), t(x), act)
        want = rlayers.gated_mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), act)
        np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    gen = torch.Generator().manual_seed(0)
    w = layers.init_dense(gen, 256, 512, torch.bfloat16)
    assert w.dtype == torch.bfloat16 and w.shape == (256, 512)
    assert abs(w.float().std().item() * math.sqrt(256) - 1.0) < 0.02
    assert torch.equal(layers.init_norm(8, torch.float32), torch.ones(8))


# ===========================================================================
# attention_decode under the four cache_update modes
# ===========================================================================

@pytest.mark.parametrize("arch", ["qwen2-0.5b", "h2o-danube-1.8b", "qwen3-32b"])
@pytest.mark.parametrize("mode", ["dus", "ring", "onehot", "deferred"])
def test_attention_decode_modes(arch, mode):
    cfg = smoke_config(arch).replace(cache_update=mode, **F32)
    rcfg = rreg.smoke_config(arch).replace(cache_update=mode, **F32)
    rp = rblocks._init_attn(jax.random.PRNGKey(3), rcfg, jnp.float32)
    # non-zero biases and norms, so both paths are exercised
    rp = {k: v + 0.1 * jnp.asarray(RNG.normal(size=v.shape), jnp.float32)
          if k.startswith(("bias", "q_norm", "k_norm")) else v for k, v in rp.items()}
    p = load_tree(blocks.Attention(cfg, torch.float32, "cpu"), rp)
    B, S, KV, hd = 2, 16, cfg.num_kv_heads, cfg.hd
    x = RNG.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    kc = RNG.normal(size=(B, S, KV, hd)).astype(np.float32)
    vc = RNG.normal(size=(B, S, KV, hd)).astype(np.float32)
    tpos = 21
    slot = tpos % S
    kpos = np.arange(S, dtype=np.int32) + 16
    kpos[kpos > tpos] -= S
    kpos[slot] = -1 if mode == "deferred" else tpos
    pos = np.full((B, 1), tpos, np.int32)
    got_x, (gk, gv) = blocks.attention_decode(p, t(x), cfg, t(kc), t(vc), tpos, t(pos),
                                              t(kpos))
    want_x, (wk, wv) = rblocks.attention_decode(
        rp, jnp.asarray(x), rcfg, jnp.asarray(kc), jnp.asarray(vc), jnp.int32(tpos),
        jnp.asarray(pos), jnp.asarray(kpos))
    np.testing.assert_allclose(n(got_x), np.asarray(want_x), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(gk), np.asarray(wk), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(gv), np.asarray(wv), rtol=1e-5, atol=1e-5)


# ===========================================================================
# the model
# ===========================================================================

def _pair(arch, **over):
    cfg = smoke_config(arch).replace(**over)
    rcfg = rreg.smoke_config(arch).replace(**over)
    rmodel = ref_build_model(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_reference(cfg, rparams))
    return cfg, model, rmodel, rparams


def _run_both(arch, steps=40, **over):
    cfg, model, rmodel, rparams = _pair(arch, **over)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(2, steps)).astype(
        np.int32)
    fwd = (n(model.forward(t(toks))[0]),
           np.asarray(jax.jit(rmodel.forward)(rparams, {"tokens": jnp.asarray(toks)})[0]))
    cache, rcache = model.init_cache(2, 64), rmodel.init_cache(2, 64)
    dec = jax.jit(rmodel.decode_step)
    got, want = [], []
    for step in range(steps):
        lg, cache = model.decode_step(cache, t(toks[:, step]), step)
        rlg, rcache = dec(rparams, rcache, jnp.asarray(toks[:, step]), jnp.int32(step))
        got.append(n(lg))
        want.append(np.asarray(rlg))
    return cfg, fwd, np.stack(got), np.stack(want), cache, rcache


@pytest.mark.parametrize("arch", DENSE)
def test_model_float32_matches_reference(arch):
    cfg, (fwd, rfwd), got, want, cache, rcache = _run_both(arch, **F32)
    np.testing.assert_allclose(fwd, rfwd, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))
    for key in ("k", "v"):
        np.testing.assert_allclose(n(cache[key]), np.asarray(rcache[key]), rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_array_equal(cache["kpos"].numpy(), np.asarray(rcache["kpos"]))
    if cfg.sliding_window:
        assert cache["k"].shape[2] == 32  # the ring wrapped: 40 steps in 32 slots


@pytest.mark.parametrize("mode", ["deferred", "onehot", "ring"])
def test_model_cache_modes_match_reference(mode):
    _, _, got, want, cache, rcache = _run_both("h2o-danube-1.8b", cache_update=mode, **F32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(n(cache["k"]), np.asarray(rcache["k"]), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", DENSE)
def test_model_bf16_within_stated_bound(arch):
    cfg, (fwd, rfwd), got, want, cache, rcache = _run_both(arch)
    assert cfg.dtype == "bfloat16" and cache["k"].dtype == torch.bfloat16
    assert np.isfinite(fwd).all() and np.isfinite(got).all()
    assert np.abs(fwd - rfwd).max() <= BF16_REL * np.abs(rfwd).max()
    assert np.abs(got - want).max() <= BF16_REL * np.abs(want).max()


def test_decode_agrees_with_forward_and_embed_scale():
    cfg = smoke_config("qwen2-0.5b").replace(**F32)
    model = build_model(cfg, device="cpu").init(seed=3)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 12)))
    fwd, _ = model.forward(toks)
    cache = model.init_cache(2, 16)
    for step in range(12):
        lg, cache = model.decode_step(cache, toks[:, step], step)
        torch.testing.assert_close(lg, fwd[:, step], rtol=1e-4, atol=1e-4)
    # the embedding scale is cast to the table's dtype before the multiply
    big = build_model(get_config("qwen2-0.5b").replace(num_layers=1, vocab_size=8),
                      device="cpu").init(seed=0)
    scale = torch.tensor(math.sqrt(896), dtype=torch.bfloat16)
    assert scale.item() == 29.875
    tok = torch.tensor([[1, 5]])
    assert torch.equal(big._embed(tok), big.embed.vocab[tok] * scale)


def test_seeded_init_is_deterministic():
    cfg = smoke_config("qwen3-32b")
    a = build_model(cfg, device="cpu").init(seed=7)
    b = build_model(cfg, device="cpu").init(seed=7)
    c = build_model(cfg, device="cpu").init(seed=8)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["layers.0.attn.wq"], sc["layers.0.attn.wq"])
    # the draw order: the embedding, then each layer's block as init_dense_block draws it
    gen = torch.Generator().manual_seed(7)
    layers.init_dense(gen, cfg.vocab_size, cfg.d_model, torch.bfloat16)
    blk = blocks.init_dense_block(gen, cfg, torch.bfloat16)
    assert all(torch.equal(v, sa[f"layers.0.{k}"]) for k, v in blk.state_dict().items())
    assert torch.equal(sa["layers.1.attn.q_norm"], torch.ones(cfg.hd, dtype=torch.bfloat16))
    # param_count leaves out the final norm (and qk-norm scales and biases)
    yi = smoke_config("yi-6b")
    assert sum(p.numel() for p in build_model(yi, device="cpu").parameters()) == (
        yi.param_count() + yi.d_model)
    # every reference parameter maps onto exactly the port's names
    rparams = ref_build_model(rreg.smoke_config("qwen3-32b")).init(jax.random.PRNGKey(0))
    assert set(params_from_reference(cfg, rparams)) == set(sa)


# ===========================================================================
# the serve loop
# ===========================================================================

def test_serve_completes_all_requests():
    cfg = smoke_config("qwen2-0.5b")
    loop = ServeLoop(cfg, batch_size=2, max_len=64, device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=list(rng.integers(0, cfg.vocab_size, 5)), max_new=4)
            for i in range(5)]  # more requests than slots -> queueing
    done = loop.run(reqs)
    assert len(done) == 5
    assert all(len(v) == 4 for v in done.values())


def test_serve_deterministic_per_prompt():
    cfg = smoke_config("qwen2-0.5b")
    prompt = [3, 1, 4, 1, 5]
    outs = []
    for _ in range(2):
        loop = ServeLoop(cfg, batch_size=1, max_len=32, device="cpu")
        outs.append(loop.run([Request(rid=0, prompt=list(prompt), max_new=6)])[0])
    assert outs[0] == outs[1]


def test_slot_reuse():
    cfg = smoke_config("qwen2-0.5b")
    loop = ServeLoop(cfg, batch_size=1, max_len=64, device="cpu")
    reqs = [Request(rid=i, prompt=[1, 2, 3], max_new=2) for i in range(3)]
    assert len(loop.run(reqs)) == 3  # one slot served three requests sequentially


@pytest.mark.parametrize("arch,batch", [("qwen2-0.5b", 2), ("h2o-danube-1.8b", 2),
                                        ("yi-6b", 1)])
def test_serve_tokens_equal_the_reference(arch, batch):
    cfg = smoke_config(arch).replace(**F32)
    ref = rserve.ServeLoop(rreg.smoke_config(arch).replace(**F32), batch, 64)
    loop = ServeLoop(cfg, batch, 64, device="cpu", params=params_from_reference(cfg, ref.params))
    rng = np.random.default_rng(4)
    prompts = [[int(x) for x in rng.integers(0, cfg.vocab_size, int(rng.integers(3, 8)))]
               for _ in range(5)]  # 5 requests through `batch` slots: slots are reused
    want = ref.run([rserve.Request(i, list(p), 6) for i, p in enumerate(prompts)])
    got = loop.run([Request(i, list(p), 6) for i, p in enumerate(prompts)])
    assert got == want and len(got) == 5


def test_serve_cli_on_the_cpu(tmp_path, capsys):
    assert serve.main(["--scale", "smoke", "--device", "cpu", "--requests", "3",
                       "--max-new", "4", "--comm-cache", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "smoother: cycle_len=1" in out
    assert "served 3/3 requests, 12 tokens" in out and "qwen2-0.5b" in out
    assert (tmp_path / "decisions.json").exists()
    # the prompts are the reference CLI's
    reqs = serve.make_requests(smoke_config("qwen2-0.5b"), 3, 4)
    rng = np.random.default_rng(0)
    assert [r.prompt for r in reqs] == [
        list(rng.integers(0, 503, size=rng.integers(4, 12))) for _ in range(3)]
