"""The port's training path against the JAX reference, on the CPU.

* Data: ``synthetic_batch`` tokens, labels and the audio / vision
  embeddings bit-equal to ``repro.data.pipeline``'s for several (seed,
  step, host) values.
* Optimizer: ``adamw_update`` on the port's per-layer dict against the
  reference's on its stacked tree, to 1e-6 relative: zero gradients
  with weight decay on (every layer's norms and biases decay, as they
  are 2-D in the stacked tree; ``final_norm`` does not), bf16 moments,
  clipping, ``global_norm``; the int8 gradient round trip bit-equal.
* Flash backward: the ``FlashAttention`` function's gradients against
  the reference's ``_flash_vjp`` on ``tests/test_flash_attention.py``'s
  gradient cases (three masks, GQA with a query offset, both head
  layouts) at float32 to 1e-5, against autograd through the plain
  chunked forward, and a bf16 case within 1% of the largest gradient.
* Train step: ``make_train_step`` (microbatches 1 and 2) and
  ``make_grad_step`` composed with its ``update_fn`` on the four dense
  smoke configs at float32, parameters carried by
  ``params_from_reference``: loss, grad norm, gradients and the updated
  parameters to rtol = atol = 1e-5; at the configs' bf16 the loss
  within 1%.
* The whole slice: the reference's initial state written as a step-0
  checkpoint by the reference, then 4 steps of the reference's
  ``train()`` and the port's ``train(device="cpu")`` from copies of it
  (qwen2-0.5b smoke at float32, seq 32, batch 4): losses to rtol 1e-5,
  final parameters to atol 1e-4.  Both resume from their
  ``step_00000002``, which holds the state after 3 updates, and apply
  batch 2 again, with equal losses.
* Checkpoints both ways: the port restores a reference-written
  checkpoint and the reference a port-written one, leaves bit-equal,
  manifests equal but for ``time``; torn-checkpoint skipping and
  retention as the reference's.
* GradWire against the reference's ``TestGradWire`` cases with
  ``repro.compat.has_ragged_all_to_all`` patched to False (XLA:CPU
  cannot run the native ragged collective): strategy, schedule,
  ``wire_bytes``, ``issued_bytes``, the probed ratio and ``describe()``
  equal; lossless modes bit-exact; ``int8`` equal to the reference's
  jitted round trip bit for bit; and the probed ratio of a smoke model's
  gradients equal to the reference's on its stacked tree.
* The CLI at ``--scale smoke --device cpu``, with and without
  ``--no-comm-cache``, and ``--grad-wire rle``.
"""

import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.compat
import repro.configs.registry as rreg
import repro.data.pipeline as rdata
import repro.launch.train as rtrain
import repro.train.checkpoint as rckpt
import repro.train.optimizer as ropt
import repro.train.train_step as rstep
from repro.comm import Communicator as RefCommunicator
from repro.configs.base import ShapeConfig as RefShapeConfig
from repro.measure.decisions import DecisionCache as RefDecisionCache
from repro.models.layers import _flash_vjp
from repro.models.model import build_model as ref_build_model
from repro.train.grad_wire import GradWire as RefGradWire

from repro_torch.comm import Communicator
from repro_torch.configs import ShapeConfig, smoke_config
from repro_torch.data import DataConfig, synthetic_batch
from repro_torch.launch import train as ptrain
from repro_torch.measure import DecisionCache
from repro_torch.models import layers
from repro_torch.models.model import build_model, params_from_reference, params_to_reference
from repro_torch.train import GRAD_WIRE_MODES, GradWire, checkpoint as pckpt
from repro_torch.train.grad_wire import int8_block_bound
from repro_torch.train import optimizer as popt
from repro_torch.train import train_step as pstep

DENSE = ("qwen2-0.5b", "h2o-danube-1.8b", "qwen3-32b", "yi-6b")
CPU = "cpu"


def flat_np(tree, prefix=""):
    """A nested tree (numpy, jax or torch leaves) as {dotted key: float64 array}."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flat_np(v, key))
        elif isinstance(v, torch.Tensor):
            out[key] = v.detach().double().numpy()
        else:
            out[key] = np.asarray(v).astype(np.float64)
    return out


def bits(x):
    """Raw bytes of a leaf (torch bf16 included) as uint8."""
    if isinstance(x, torch.Tensor):
        x = x.detach().contiguous()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().reshape(-1).view(np.uint8)
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def assert_trees_close(got, want, rtol, atol, what=""):
    g, w = flat_np(got), flat_np(want)
    assert sorted(g) == sorted(w), (what, sorted(g), sorted(w))
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol, err_msg=f"{what} {k}")


def ref_state(cfg, seed=0):
    """The reference's parameters from ``PRNGKey(seed)``."""
    return ref_build_model(cfg).init(jax.random.PRNGKey(seed))


def port_model(pcfg, ref_params):
    model = build_model(pcfg, device=CPU)
    model.load_state_dict(params_from_reference(pcfg, ref_params))
    return model


# ===========================================================================
# data
# ===========================================================================

@pytest.mark.parametrize("arch", ["qwen2-0.5b", "seamless-m4t-large-v2", "qwen2-vl-2b"])
def test_synthetic_batches_are_the_references(arch):
    cfg, rcfg = smoke_config(arch), rreg.smoke_config(arch)
    for seed, step, hosts, host in ((0, 0, 1, 0), (0, 7, 1, 0), (3, 2, 2, 1), (11, 5, 4, 3)):
        shape = ShapeConfig("t", 16, 8, "train")
        got = synthetic_batch(cfg, shape, step, DataConfig(seed, hosts, host), device=CPU)
        want = rdata.synthetic_batch(rcfg, RefShapeConfig("t", 16, 8, "train"), step,
                                     rdata.DataConfig(seed, hosts, host))
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == (torch.bfloat16 if "embeds" in k else torch.int32)
            assert got[k].shape == want[k].shape
            np.testing.assert_array_equal(bits(got[k]), bits(want[k]), err_msg=k)


# ===========================================================================
# optimizer
# ===========================================================================

def _opt_case(cfg_kw, seed=0, zero_grads=False):
    """A reference-stacked float32 tree (qwen2 smoke: norms, biases,
    tied embedding) with seeded gradients, and its per-layer copy."""
    rcfg = rreg.smoke_config("qwen2-0.5b").replace(dtype="float32")
    pcfg = smoke_config("qwen2-0.5b").replace(dtype="float32")
    rng = np.random.default_rng(seed)
    # moved off the init, so the zero-initialized biases are not zero
    params = jax.tree.map(lambda p: p + jnp.asarray(rng.normal(size=p.shape) * 0.1, p.dtype),
                          ref_state(rcfg, seed))
    grads = jax.tree.map(
        lambda p: np.zeros(p.shape, np.float32) if zero_grads
        else (rng.normal(size=p.shape) * 0.3).astype(np.float32), params)
    opt_cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, **cfg_kw)
    return rcfg, pcfg, params, grads, opt_cfg


@pytest.mark.parametrize("case", ["plain", "zero_grads", "bf16_moments", "clipped"])
def test_adamw_matches_the_reference_on_the_stacked_tree(case):
    kw = {"bf16_moments": {"moment_dtype": "bfloat16"}, "clipped": {"clip_norm": 1e-3}}
    rcfg, pcfg, params, grads, cfg_kw = _opt_case(kw.get(case, {}), zero_grads=case == "zero_grads")
    rc, pc = ropt.AdamWConfig(**cfg_kw), popt.AdamWConfig(**cfg_kw)
    rp, rs = params, ropt.init_opt_state(params, rc)
    pp = {k: v.clone() for k, v in params_from_reference(pcfg, params).items()}
    ps = popt.init_opt_state(pp, pc)
    pg = params_from_reference(pcfg, grads)
    ref_update = jax.jit(ropt.adamw_update, static_argnums=3)
    # three steps cross the warmup into the cosine.  bf16 moments: the
    # float32 values agree to an ulp or so (the global norm sums in
    # another order, XLA fuses multiply-adds), which can round a moment
    # to the neighbouring bf16 value; so they are held to one bf16 ulp
    # (2**-7 relative at worst), after one step, whose parameter update
    # reads the float32 moments
    steps = 1 if case == "bf16_moments" else 3
    moment_rtol = 2.0 ** -7 if case == "bf16_moments" else 1e-6
    for _ in range(steps):
        rp, rs, rm = ref_update(rp, grads, rs, rc)
        pp, ps, pm = popt.adamw_update(pp, pg, ps, pc)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(pm[k]), float(rm[k]), rtol=1e-6, atol=0)
    assert int(ps["step"]) == int(rs["step"]) == steps and ps["step"].dtype == torch.int32
    assert_trees_close(params_to_reference(pcfg, pp), rp, 1e-6, 1e-7, "params")
    for m in ("mu", "nu"):
        assert ps[m]["embed.vocab"].dtype == (torch.bfloat16 if case == "bf16_moments"
                                              else torch.float32)
        assert_trees_close(params_to_reference(pcfg, ps[m]), rs[m], moment_rtol, 1e-7, m)
    if case == "zero_grads":
        # decay alone: every layers.* leaf (norms and biases included)
        # and the embedding move, final_norm does not
        start = params_from_reference(pcfg, params)
        for name, p in pp.items():
            moved = not torch.equal(p, start[name])
            assert moved == (name != "final_norm"), name
        assert popt.decays("layers.3.attn.bias_q", pp["layers.3.attn.bias_q"])
        assert not popt.decays("final_norm", pp["final_norm"])
    if case == "clipped":
        assert float(pm["grad_norm"]) > 1e-3  # the raw norm is reported


def test_global_norm_and_int8_round_trip_are_the_references():
    rng = np.random.default_rng(4)
    tree = {"a": rng.normal(size=(3, 5)).astype(np.float32),
            "b": rng.normal(size=(7,)).astype(np.float32)}
    got = popt.global_norm({k: torch.from_numpy(v) for k, v in tree.items()})
    np.testing.assert_allclose(float(got), float(ropt.global_norm(tree)), rtol=1e-6)
    assert float(popt.global_norm({"x": torch.ones(3), "y": torch.ones(4)})) == pytest.approx(
        np.sqrt(7.0))
    for n in (1, 256, 1000):
        g = (rng.normal(size=(n,)) * 3).astype(np.float32)
        q, scale = popt.quantize_grad_int8(torch.from_numpy(g))
        rq, rscale = ropt.quantize_grad_int8(jnp.asarray(g))
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        assert bits(scale).tobytes() == bits(np.asarray(rscale)).tobytes()
        back = popt.dequantize_grad_int8(q, scale)
        np.testing.assert_array_equal(bits(back), bits(ropt.dequantize_grad_int8(rq, rscale)))
        assert float((back - torch.from_numpy(g)).abs().max()) <= float(scale) * 0.51


# ===========================================================================
# flash backward
# ===========================================================================

RNG = np.random.default_rng(0)


def _qkv(B, Sq, Sk, H, KVH, D):
    return [(RNG.normal(size=s) * 0.5).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Sk, KVH, D), (B, Sk, KVH, D))]


FLASH_CASES = [  # (causal, window, q_offset, chunk, merged, shape)
    (True, None, 0, 8, False, (1, 32, 32, 4, 2, 16)),
    (True, 16, 0, 8, False, (1, 32, 32, 4, 2, 16)),
    (False, None, 0, 8, False, (1, 32, 32, 4, 2, 16)),
    (True, None, 16, 5, False, (2, 4, 20, 8, 2, 16)),
    (True, None, 16, 5, True, (2, 4, 20, 8, 2, 16)),
    (True, None, 0, 8, True, (1, 32, 32, 4, 2, 16)),
]


def _port_grads(fn, q, k, v, dtype=torch.float32):
    ts = [torch.tensor(a).to(dtype).requires_grad_(True) for a in (q, k, v)]
    torch.sin(fn(*ts).float()).sum().backward()
    return [t.grad for t in ts]


@pytest.mark.parametrize("causal,window,q_offset,chunk,merged,shape", FLASH_CASES)
def test_flash_backward_is_the_references(causal, window, q_offset, chunk, merged, shape):
    q, k, v = _qkv(*shape)
    fa = _flash_vjp(causal, window, q_offset, chunk, merged)
    want = jax.grad(lambda q, k, v: jnp.sum(jnp.sin(fa(q, k, v))), argnums=(0, 1, 2))(q, k, v)
    kw = dict(causal=causal, window=window, q_offset=q_offset, chunk=chunk, merged=merged)
    got = _port_grads(lambda q, k, v: layers.flash_attention(q, k, v, **kw), q, k, v)
    # the plain reference of the port: autograd through the chunk loop
    plain = _port_grads(lambda q, k, v: layers._flash_forward(
        q, k, v, causal, window, q_offset, chunk, merged)[0], q, k, v)
    for g, w, p, name in zip(got, want, plain, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5,
                                   err_msg=f"d{name}")
        np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=f"d{name} vs autograd")


@pytest.mark.parametrize("merged", [False, True])
def test_flash_backward_bf16_within_one_percent(merged):
    q, k, v = _qkv(2, 32, 32, 4, 2, 16)
    fa = _flash_vjp(True, None, 0, 8, merged)
    cast = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = jax.grad(lambda q, k, v: jnp.sum(jnp.sin(fa(q, k, v).astype(jnp.float32))),
                    argnums=(0, 1, 2))(*cast)
    rounded = [np.asarray(a.astype(jnp.float32)) for a in cast]  # the same bf16 inputs
    got = _port_grads(lambda q, k, v: layers.flash_attention(q, k, v, chunk=8, merged=merged),
                      *rounded, dtype=torch.bfloat16)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w.astype(jnp.float32))
        assert np.abs(g.float().numpy() - w).max() <= 0.01 * np.abs(w).max()


# ===========================================================================
# the train step
# ===========================================================================

def _step_case(arch, dtype="float32", microbatches=1):
    rcfg = rreg.smoke_config(arch).replace(dtype=dtype, microbatches=microbatches)
    pcfg = smoke_config(arch).replace(dtype=dtype, microbatches=microbatches)
    params = ref_state(rcfg)
    shape = RefShapeConfig("train", 16, 4, "train")
    batch = rdata.synthetic_batch(rcfg, shape, 1)
    pbatch = synthetic_batch(pcfg, ShapeConfig("train", 16, 4, "train"), 1, device=CPU)
    # the launcher's AdamW (lr 3e-6 at step 1): the key bias's gradient is
    # rounding noise (a shift of every key leaves the softmax alone),
    # which Adam's first step turns into +-lr, so one flipped sign moves
    # a parameter by 2 lr, inside the 1e-5 tolerance
    opt_kw = dict(total_steps=10)
    return rcfg, pcfg, params, batch, pbatch, opt_kw


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", DENSE)
def test_train_step_is_the_references(arch, microbatches):
    rcfg, pcfg, params, batch, pbatch, opt_kw = _step_case(arch, microbatches=microbatches)
    rmodel, rc, pc = ref_build_model(rcfg), ropt.AdamWConfig(**opt_kw), popt.AdamWConfig(**opt_kw)
    ropt_state = ropt.init_opt_state(params, rc)
    r_grad_fn, _ = rstep.make_grad_step(rmodel, rc)
    rloss, _, rgrads = jax.jit(r_grad_fn)(params, batch)
    rp, _, rm = jax.jit(rstep.make_train_step(rmodel, rc))(params, ropt_state, batch)

    # the port, fused
    model = port_model(pcfg, params)
    pp = model.trainable()
    pp, ps, pm = pstep.make_train_step(model, pc)(pp, popt.init_opt_state(pp, pc), pbatch)
    np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(pm["grad_norm"]), float(rm["grad_norm"]), rtol=1e-5,
                               atol=1e-5)
    assert_trees_close(params_to_reference(pcfg, pp), rp, 1e-5, 1e-5, "params")
    fused = {k: v.clone() for k, v in pp.items()}

    # the port, split: grad_fn then update_fn runs the fused step's ops
    model = port_model(pcfg, params)
    pp = model.trainable()
    grad_fn, update_fn = pstep.make_grad_step(model, pc)
    loss, metrics, grads = grad_fn(pp, pbatch)
    want_dtype = torch.float32  # smoke configs at float32; float32 accumulators either way
    assert all(g.dtype == want_dtype for g in grads.values())
    assert list(grads) == list(pp)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5, atol=1e-5)
    assert_trees_close(params_to_reference(pcfg, grads), rgrads, 1e-5, 1e-5, "grads")
    pp, _, m2 = update_fn(pp, popt.init_opt_state(pp, pc), grads, loss, metrics)
    assert float(m2["loss"]) == float(pm["loss"])
    for k in pp:
        assert torch.equal(pp[k], fused[k]), k


def test_one_micro_batch_keeps_the_parameters_dtype_and_bf16_loss_within_one_percent():
    for mb in (1, 2):
        rcfg, pcfg, params, batch, pbatch, opt_kw = _step_case("qwen2-0.5b", "bfloat16", mb)
        rloss = jax.jit(lambda p, b: rstep.make_loss_fn(ref_build_model(rcfg))(p, b)[0])(
            params, batch)
        model = port_model(pcfg, params)
        pp = model.trainable()
        loss, _, grads = pstep.make_grad_step(model, popt.AdamWConfig(**opt_kw))[0](pp, pbatch)
        assert abs(float(loss) - float(rloss)) <= 0.01 * abs(float(rloss))
        want = torch.bfloat16 if mb == 1 else torch.float32
        assert {g.dtype for g in grads.values()} == {want}


def test_steps_reject_params_that_are_not_the_models():
    """The steps differentiate and update the module's own parameters:
    copies, another model's parameters or a subset raise rather than
    being silently ignored."""
    _, pcfg, params, _, pbatch, opt_kw = _step_case("qwen2-0.5b")
    model = port_model(pcfg, params)
    pp = model.trainable()
    other = port_model(pcfg, params).trainable()
    loss_fn = pstep.make_loss_fn(model)
    grad_fn, _ = pstep.make_grad_step(model, popt.AdamWConfig(**opt_kw))
    for bad in ({k: v.detach().clone() for k, v in pp.items()}, other,
                dict(list(pp.items())[1:])):
        with pytest.raises(ValueError, match="own parameters"):
            loss_fn(bad, pbatch)
        with pytest.raises(ValueError, match="own parameters"):
            grad_fn(bad, pbatch)
    assert torch.isfinite(loss_fn(pp, pbatch)[0])


def test_cross_entropy_is_the_references():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(2, 5, 11)).astype(np.float32) * 4
    labels = rng.integers(0, 11, size=(2, 5)).astype(np.int32)
    got = pstep.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    want = rstep.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ===========================================================================
# the whole slice: train(), resume, checkpoints
# ===========================================================================

SLICE = dict(steps=4, seq_len=32, global_batch=4)


@pytest.fixture(scope="module")
def slice_runs(tmp_path_factory):
    """The reference's initial state as a step-0 checkpoint, and 4 steps
    of each package's ``train()`` from a copy of it (checkpoints every 2
    steps)."""
    root = tmp_path_factory.mktemp("slice")
    rcfg = rreg.smoke_config("qwen2-0.5b").replace(dtype="float32")
    pcfg = smoke_config("qwen2-0.5b").replace(dtype="float32")
    params = ref_state(rcfg)
    opt_cfg = ropt.AdamWConfig(moment_dtype=rcfg.opt_moment_dtype, total_steps=10)
    rckpt.save_checkpoint(str(root / "init"), 0, {"params": params,
                                                   "opt": ropt.init_opt_state(params, opt_cfg)})
    for who in ("ref", "port"):
        shutil.copytree(root / "init", root / who)
    assert jax.device_count() < 4  # one device: the reference takes no mesh
    ref = rtrain.train(rcfg, ckpt_dir=str(root / "ref"), ckpt_every=2, **SLICE)
    port = ptrain.train(pcfg, ckpt_dir=str(root / "port"), ckpt_every=2, device=CPU, **SLICE)
    return dict(root=root, rcfg=rcfg, pcfg=pcfg, ref=ref, port=port)


def test_train_is_the_references(slice_runs):
    ref, port, pcfg = slice_runs["ref"], slice_runs["port"], slice_runs["pcfg"]
    assert len(port["losses"]) == 4
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=1e-5)
    assert all(np.isfinite(port["grad_norms"]))
    assert_trees_close(params_to_reference(pcfg, port["params"]), ref["params"], 0, 1e-4,
                       "final params")
    for who in ("ref", "port"):
        assert sorted(os.listdir(slice_runs["root"] / who)) == [
            "step_00000000", "step_00000002", "step_00000004"]


def test_resume_repeats_the_saved_steps_batch(slice_runs):
    root, rcfg, pcfg = slice_runs["root"], slice_runs["rcfg"], slice_runs["pcfg"]
    for who in ("ref", "port"):
        shutil.copytree(root / who / "step_00000002", root / f"resume_{who}" / "step_00000002")
    step, tree = pckpt.restore_checkpoint(str(root / "resume_port"))
    assert step == 2 and int(tree["opt"]["step"]) == 3  # saved after the third update
    ref = rtrain.train(rcfg, ckpt_dir=str(root / "resume_ref"), ckpt_every=100, **SLICE)
    port = ptrain.train(pcfg, ckpt_dir=str(root / "resume_port"), ckpt_every=100, device=CPU,
                        **SLICE)
    assert len(port["losses"]) == len(ref["losses"]) == 2
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=1e-5)
    # the first resumed loss is batch 2 applied to the saved state
    model = build_model(pcfg, device=CPU)
    params, _ = pckpt.load_train_state(model, tree)
    batch = synthetic_batch(pcfg, ShapeConfig("train", 32, 4, "train"), 2, device=CPU)
    with torch.no_grad():
        loss, _ = pstep.make_loss_fn(model)(params, batch)
    assert float(loss) == port["losses"][0]
    # and it is not the uninterrupted run's step-2 loss (state after 2 updates)
    assert port["losses"][0] != slice_runs["port"]["losses"][2]


def test_encdec_qkv_bias_trains_as_the_reference(tmp_path):
    """The encoder-decoder with ``qkv_bias``: its cross-attention biases
    are parameters that the forward never reads.  ``jax.grad`` gives them
    zero gradients and the port's step zero gradients too
    (``materialize_grads``), so both train 2 steps alike from the
    reference's initial state and the dead biases stay exactly 0."""
    rcfg = rreg.smoke_config("seamless-m4t-large-v2").replace(dtype="float32", qkv_bias=True)
    pcfg = smoke_config("seamless-m4t-large-v2").replace(dtype="float32", qkv_bias=True)
    params = ref_state(rcfg)
    opt_cfg = ropt.AdamWConfig(moment_dtype=rcfg.opt_moment_dtype, total_steps=10)
    rckpt.save_checkpoint(str(tmp_path / "ref"), 0, {"params": params,
                                                     "opt": ropt.init_opt_state(params, opt_cfg)})
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    run = dict(steps=2, seq_len=32, global_batch=2, ckpt_every=100)
    ref = rtrain.train(rcfg, ckpt_dir=str(tmp_path / "ref"), **run)
    port = ptrain.train(pcfg, ckpt_dir=str(tmp_path / "port"), device=CPU, **run)
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=1e-5)
    dead = [k for k in port["params"] if k.startswith("xattn.") and ".bias_" in k]
    assert len(dead) == 3 * pcfg.num_layers
    for k in dead:
        assert not port["params"][k].any(), k
    for k in ("bias_q", "bias_k", "bias_v"):
        assert not np.asarray(ref["params"]["xattn"][k]).any(), k


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        m = json.load(f)
    m.pop("time")
    return m


def test_checkpoints_restore_both_ways(tmp_path):
    rcfg, pcfg = rreg.smoke_config("qwen2-0.5b"), smoke_config("qwen2-0.5b")  # bf16 params
    params = ref_state(rcfg, seed=1)
    rng = np.random.default_rng(5)
    opt = ropt.init_opt_state(params, ropt.AdamWConfig())
    opt = {"mu": jax.tree.map(lambda m: rng.normal(size=m.shape).astype(np.float32), opt["mu"]),
           "nu": jax.tree.map(lambda m: rng.random(size=m.shape).astype(np.float32), opt["nu"]),
           "step": np.int32(7)}
    state = {"params": params, "opt": opt}
    rckpt.save_checkpoint(str(tmp_path / "ref"), 7, state)

    # the port reads the reference's
    step, tree = pckpt.restore_checkpoint(str(tmp_path / "ref"))
    assert step == 7
    want = {k: bits(v) for k, v in rckpt._flatten(state).items()}
    got = pckpt._flatten(tree)
    assert sorted(got) == sorted(want)
    for k in want:
        assert bits(got[k]).tobytes() == want[k].tobytes(), k
    assert got["params.embed.vocab"].dtype == torch.bfloat16
    assert got["opt.step"].dtype == torch.int32 and got["opt.step"].shape == ()

    # ... loads it into a model and writes the same checkpoint back
    model = build_model(pcfg, device=CPU)
    pp, ps = pckpt.load_train_state(model, tree)
    assert int(ps["step"]) == 7
    pckpt.save_checkpoint(str(tmp_path / "port"), 7, pckpt.train_state(model, pp, ps))
    assert _manifest(tmp_path / "port" / "step_00000007") == _manifest(
        tmp_path / "ref" / "step_00000007")

    # the reference reads the port's
    rstep_, rtree = rckpt.restore_checkpoint(str(tmp_path / "port"))
    assert rstep_ == 7
    for k, v in rckpt._flatten(rtree).items():
        assert str(np.asarray(v).dtype) == str(np.asarray(rckpt._flatten(state)[k]).dtype), k
        assert bits(v).tobytes() == want[k].tobytes(), k


def test_torn_checkpoints_and_retention_as_the_reference(tmp_path):
    for mod, d in ((pckpt, tmp_path / "port"), (rckpt, tmp_path / "ref")):
        mod.save_checkpoint(str(d), 1, {"w": np.ones(3)})
        os.makedirs(d / "step_00000002")
        (d / "step_00000002" / "shards.npz").write_bytes(b"garbage")
        os.makedirs(d / "step_00000003.tmp")
        assert mod.latest_step(str(d)) == 1
        assert mod.restore_checkpoint(str(d))[0] == 1
        for s in (4, 5, 6, 7):
            mod.save_checkpoint(str(d), s, {"w": np.full(2, s)}, keep=2)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "ref")) == [
        "step_00000002", "step_00000003.tmp", "step_00000006", "step_00000007"]
    mgr = pckpt.CheckpointManager(str(tmp_path / "mgr"), every=2)
    assert mgr.restore_or_init(lambda: "fresh") == (0, "fresh")
    calls = []
    assert mgr.maybe_save(3, lambda: calls.append(3)) is None and not calls  # not due: not built
    assert mgr.maybe_save(4, lambda: {"w": np.ones(1)}).endswith("step_00000004")
    assert mgr.restore_or_init(lambda: "fresh")[0] == 4


# ===========================================================================
# GradWire
# ===========================================================================

@pytest.fixture
def no_native_ragged(monkeypatch):
    """The reference takes its native ragged collective when this JAX has
    one; XLA:CPU cannot run it and the port's local mesh has none.  The
    reference's plan cache is cleared around the test (its key does not
    hold the answer), so no plan leaks to a later test."""
    import repro.comm.wireplan as rwp

    monkeypatch.setattr(repro.compat, "has_ragged_all_to_all", lambda: False)
    rwp.plan_wire.cache_clear()
    yield
    rwp.plan_wire.cache_clear()


def _grad_tree():
    """The reference test's gradients (a sparsely updated embedding),
    in ``jax.tree.leaves`` order."""
    rng = np.random.RandomState(3)
    emb = np.zeros((64, 16), np.float32)
    emb[5] = rng.randn(16)
    w = np.zeros((16, 16), np.float32)
    w[3, :4] = rng.randn(4) * 0.1
    return {"b": np.zeros((16,), np.float32), "emb": emb, "w": w}


def _ref_exchange(mode, grads, params):
    dc = RefDecisionCache()
    wire = RefGradWire(RefCommunicator(axis_name="x", params=params, decisions=dc), mode=mode)
    out = wire.exchange({k: jnp.asarray(v) for k, v in grads.items()})
    return wire, {k: np.asarray(v) for k, v in out.items()}, dc


def test_grad_wire_modes_and_passthrough():
    assert GRAD_WIRE_MODES == ("off", "auto", "rle", "int8")
    with pytest.raises(ValueError, match="unknown grad-wire mode"):
        GradWire(Communicator(device=CPU), mode="zstd")
    wire = GradWire(Communicator(device=CPU), mode="off")
    grads = {k: torch.from_numpy(v) for k, v in _grad_tree().items()}
    assert wire.exchange(grads) is grads and not wire.planned
    assert wire.describe() == "grad-wire mode=off (unplanned)"


@pytest.mark.parametrize("tables", ["h100", "tpu_v5e"])
@pytest.mark.parametrize("mode", ["auto", "rle", "int8"])
def test_grad_wire_is_the_references(no_native_ragged, mode, tables):
    from test_torch_comm import _param_pair

    ref_params, params = _param_pair(tables)
    grads = _grad_tree()
    ref_wire, want, ref_dc = _ref_exchange(mode, grads, ref_params)
    dc = DecisionCache()
    wire = GradWire(Communicator(params=params, device=CPU, axis_name="x", decisions=dc),
                    mode=mode)
    got = wire.exchange({k: torch.from_numpy(v.copy()) for k, v in grads.items()})
    assert wire.planned and list(got) == list(grads)
    p, rp = wire._plan_fwd, ref_wire._plan_fwd
    assert wire._strats[0].name == ref_wire._strats[0].name
    assert (p.schedule, p.wire_bytes, p.issued_bytes, p.stream_bytes, p.stream_ratio) == (
        rp.schedule, rp.wire_bytes, rp.issued_bytes, rp.stream_bytes, rp.stream_ratio)
    assert wire._plan_back.fingerprint == ref_wire._plan_back.fingerprint
    assert wire.describe() == ref_wire.describe()
    assert dc.to_json() == ref_dc.to_json()
    for k in grads:
        assert bits(got[k]).tobytes() == bits(want[k]).tobytes(), k
        if mode != "int8":  # lossless: the identity
            assert bits(got[k]).tobytes() == bits(grads[k]).tobytes(), k
    if mode == "rle":
        assert p.schedule == "varlen" and p.effective_wire_bytes < p.wire_bytes
    if mode == "int8":
        assert not p.stream_bytes  # lossy: never probed
        for k, g in grads.items():
            tol = 2 * (np.max(np.abs(g)) / 127 + 1e-7)
            assert np.max(np.abs(got[k].numpy() - g)) <= tol, k


def test_grad_wire_probes_a_model_gradient_as_the_reference(no_native_ragged):
    """A smoke model's gradients in the port's trainable order give the
    reference's byte stream, so the same probed ratio and picks."""
    rcfg = rreg.smoke_config("qwen2-0.5b").replace(dtype="float32")
    pcfg = smoke_config("qwen2-0.5b").replace(dtype="float32")
    params = ref_state(rcfg)
    batch = rdata.synthetic_batch(rcfg, RefShapeConfig("train", 16, 2, "train"), 0)
    _, _, rgrads = jax.jit(rstep.make_grad_step(ref_build_model(rcfg), ropt.AdamWConfig())[0])(
        params, batch)
    from test_torch_comm import _param_pair

    ref_params, tables = _param_pair("h100")
    ref_wire = RefGradWire(RefCommunicator(axis_name="x", params=ref_params), mode="auto")
    ref_wire.plan_for(rgrads)
    model = port_model(pcfg, params)
    order = list(model.trainable())
    flat = params_from_reference(pcfg, rgrads)
    grads = {k: flat[k] for k in order}
    wire = GradWire(Communicator(params=tables, device=CPU, axis_name="x"), mode="auto")
    wire.plan_for(grads)
    assert wire.describe() == ref_wire.describe()
    out = wire.exchange(grads)
    for k in grads:
        assert torch.equal(out[k], grads[k]), k


def test_wire_between_the_halves_preserves_training():
    pcfg = smoke_config("qwen2-0.5b").replace(dtype="float32")
    params = ref_state(rreg.smoke_config("qwen2-0.5b").replace(dtype="float32"))
    batch = synthetic_batch(pcfg, ShapeConfig("train", 16, 2, "train"), 0, device=CPU)
    opt_cfg = popt.AdamWConfig(total_steps=10)
    finals = {}
    for mode in ("off", "rle", "auto"):
        model = port_model(pcfg, params)
        pp = model.trainable()
        grad_fn, update_fn = pstep.make_grad_step(model, opt_cfg)
        wire = GradWire(Communicator(device=CPU), mode=mode)
        loss, metrics, grads = grad_fn(pp, batch)
        pp, _, m = update_fn(pp, popt.init_opt_state(pp, opt_cfg), wire.exchange(grads), loss,
                             metrics)
        finals[mode] = (float(m["loss"]), {k: v.clone() for k, v in pp.items()})
    for mode in ("rle", "auto"):
        assert finals[mode][0] == finals["off"][0]
        for k, v in finals["off"][1].items():
            assert torch.equal(finals[mode][1][k], v), (mode, k)


def test_int8_wire_widens_bf16_gradients():
    """The int8 wire quantizes float32 words: bf16 leaves ride it widened
    to float32 and come back in their dtype within the wire's bound."""
    rng = np.random.default_rng(6)
    grads = {"a": torch.from_numpy(rng.normal(size=(33, 7)).astype(np.float32)).bfloat16(),
             "b": torch.from_numpy(rng.normal(size=(500,)).astype(np.float32) * 1e-3).bfloat16(),
             "c": torch.from_numpy(rng.normal(size=(256,)).astype(np.float32)).bfloat16()}
    wire = GradWire(Communicator(device=CPU), mode="int8")
    out = wire.exchange(grads)
    n = 33 * 7 + 500 + 256
    assert wire._plan_fwd.wire_bytes == 4 * -(-n // 256) + n  # a scale a block, an int8 a float
    bound = int8_block_bound(grads)
    for k, g in grads.items():
        assert out[k].dtype == torch.bfloat16
        assert bool(((out[k].float() - g.float()).abs() <= bound[k]).all()), k
    # "b" shares its first and last blocks with "a" and "c": only there
    # does the per-leaf bound not hold; its inner block keeps it
    inner = slice(256 - 231, 256 - 231 + 256)
    tol = 2 * (float(grads["b"].float().abs().max()) / 127 + 1e-7)
    err = (out["b"].float() - grads["b"].float()).abs()
    assert float(err[inner].max()) <= tol + float(grads["b"].float().abs().max()) * 2.0 ** -8


# ===========================================================================
# the CLI
# ===========================================================================

@pytest.fixture
def default_steps():
    """The CLI installs the process-wide deep-halo depth; put it back."""
    from repro_torch.halo.program import get_default_halo_steps, set_default_halo_steps

    before = get_default_halo_steps()
    yield
    set_default_halo_steps(before)


@pytest.mark.parametrize("extra", [["--no-comm-cache"], [], ["--grad-wire", "rle"]])
def test_cli_on_the_cpu(tmp_path, capsys, extra, default_steps):
    argv = ["--arch", "qwen2-0.5b", "--scale", "smoke", "--device", "cpu", "--steps", "2",
            "--seq-len", "16", "--global-batch", "2", "--ckpt-dir", str(tmp_path / "ckpt"),
            "--comm-cache", str(tmp_path / "store")] + extra
    out = ptrain.main(argv)
    text = capsys.readouterr().out
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert "loss: first=" in text and "step     1 loss" in text
    if "--no-comm-cache" in extra:
        assert "comm:" not in text and "comm_stats" not in out
    else:
        assert "smoother:" in text and "pinned hits) ->" in text
        assert (tmp_path / "store" / "decisions.json").exists()
    if "rle" in extra:
        assert "grad-wire mode=rle strategy=rlewire" in text
    if extra == ["--no-comm-cache"]:
        with pytest.raises(ValueError, match="needs a communicator"):
            ptrain.main(argv + ["--grad-wire", "auto"])
