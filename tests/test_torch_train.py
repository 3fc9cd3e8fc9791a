"""The port's training path (``paddle_hackathon_tpu_torch``) against the
JAX package's on shared weights: a tiny GPT built in JAX, exported with
``state_dict()`` and loaded with ``load_jax_state``, trained by both
``make_sharded_train_step``s (JAX on a 1-device CPU mesh) from the same
numpy batches.

- f32, plain attention: 3-step loss series at rtol 1e-5 and the updated
  parameters at atol 1e-5 (the same sums in other orders), with the clip
  idle (1.0) and engaged (1e-3).  Adam's epsilon is 1e-6 there: at the
  default 1e-8 a gradient entry near 0 moves its parameter by about
  ``lr * sign(g)``, so a 1e-9 difference in g becomes a 1e-3 difference
  in the parameter.
- bf16 parameters with flash attention (K1: the JAX Pallas kernel under
  the interpreter, the port's plain version on the CPU): 2-step loss
  series at rtol 2e-4.  Both sides take the loss in f32 from bf16 logits
  but round matrix products and layer norms to bf16 at slightly
  different points (measured relative difference 2.3e-5).
- f32 parameters with flash asked for (K2 through scaled_dot_product
  _attention, the JAX kernel under the interpreter): 3-step loss series
  at rtol 1e-5.
- The step's one-device options (``master_weights``, ``optimizer="lamb"``,
  a custom ``loss_fn``, a ``rule``) and eager Adam's options (coupled weight
  decay, a clip, a scheduler, ``multi_precision``): 3-step series against
  JAX, f32.
- ``cross_entropy`` with ``ignore_index``, eager ``Adam.step()``, and the
  multi-device options the port refuses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_hackathon_tpu as paddle
from paddle_hackathon_tpu import parallel as jparallel
from paddle_hackathon_tpu.core.tensor import Tensor
from paddle_hackathon_tpu.models.gpt import GPTConfig as JConfig
from paddle_hackathon_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_hackathon_tpu.models.gpt import \
    param_sharding_spec as jparam_sharding_spec
from paddle_hackathon_tpu.nn.layer import functional_call as jfunctional_call
from paddle_hackathon_tpu.nn.functional import loss as jloss
from paddle_hackathon_tpu_torch.models import gpt as tgpt
from paddle_hackathon_tpu_torch import nn as tnn
from paddle_hackathon_tpu_torch.nn.functional import (cross_entropy,
                                                      fused_softmax_ce_rows)
from paddle_hackathon_tpu_torch import optimizer as toptim
from paddle_hackathon_tpu_torch.optimizer import Adam
from paddle_hackathon_tpu_torch.parallel import make_sharded_train_step
from paddle_hackathon_tpu_torch.utils import load_jax_state, state_to_numpy

_CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            max_position_embeddings=128, hidden_dropout_prob=0.0,
            attention_dropout_prob=0.0, use_flash_attention=False)


def _pair(cfg, seed=3):
    paddle.seed(seed)
    jm = JGPT(JConfig(**cfg))
    arrays = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = load_jax_state(tgpt.GPTForCausalLM(tgpt.GPTConfig(**cfg),
                                            device="cpu"), arrays)
    return jm, tm


def _batches(n, b, s, vocab, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, vocab, (b, s)).astype(np.int32),
             rng.randint(0, vocab, (b, s)).astype(np.int32))
            for _ in range(n)]


def _train_both(cfg, batches, param_dtype=None, jkw=(), tkw=(), **kw):
    """Train both packages on ``batches``; ``kw`` goes to both steps,
    ``jkw`` / ``tkw`` to the JAX / port step alone."""
    jm, tm = _pair(cfg)
    mesh = jparallel.create_mesh({"dp": 1}, devices=jax.devices()[:1])
    jstep, jstate = jparallel.make_sharded_train_step(
        jm, mesh, zero_stage=0, param_dtype=param_dtype, **kw, **dict(jkw))
    tstep, tstate = make_sharded_train_step(tm, param_dtype=param_dtype,
                                            **kw, **dict(tkw))
    jl, tl = [], []
    for i, (ids, labels) in enumerate(batches):
        jstate, loss = jstep(jstate, jnp.asarray(ids), jnp.asarray(labels),
                             jax.random.PRNGKey(i))
        jl.append(float(loss))
        tstate, loss = tstep(tstate, ids, labels)
        tl.append(float(loss))
    return jl, tl, jstate, tm


@pytest.mark.parametrize("clip", [1.0, 1e-3])
def test_f32_train_steps_match_jax(clip):
    batches = _batches(3, 2, 16, 128)
    jl, tl, jstate, tm = _train_both(_CFG, batches, learning_rate=1e-3,
                                     grad_clip_norm=clip,
                                     optimizer_kwargs={"epsilon": 1e-6})
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[0] != tl[-1]
    params = state_to_numpy(tm)
    assert set(params) == set(jstate["params"])
    for k, v in jstate["params"].items():
        np.testing.assert_allclose(params[k], np.asarray(v), rtol=0,
                                   atol=1e-5, err_msg=k)


def test_bf16_flash_train_steps_match_jax():
    cfg = dict(_CFG, hidden_size=128, num_heads=2, use_flash_attention=True)
    batches = _batches(2, 1, 128, 128, seed=1)
    jl, tl, jstate, tm = _train_both(cfg, batches, param_dtype="bfloat16",
                                     learning_rate=1e-3)
    assert tm.gpt.wte.weight.dtype == torch.bfloat16
    # the model took the packed flash branch (the plain version on the CPU)
    qkv = torch.zeros(1, 128, 384, dtype=torch.bfloat16)
    assert tm.gpt.blocks[0].attn._packed_flash_ok(qkv, 128)
    np.testing.assert_allclose(tl, jl, rtol=2e-4)
    params = state_to_numpy(tm)
    np.testing.assert_array_equal(
        params["gpt.wte.weight"].dtype,
        np.asarray(jstate["params"]["gpt.wte.weight"]).dtype)


def test_f32_flash_train_steps_match_jax(monkeypatch):
    """f32 parameters (``param_dtype=None``) with flash asked for: the
    packed kernels refuse f32, so both packages run SDPA's bhd flash path
    (K2: the JAX kernel under the interpreter, the port's plain version on
    the CPU).  3-step loss series at rtol 1e-5."""
    from paddle_hackathon_tpu_torch.incubate.nn.kernels import \
        flash_attention as tfa
    calls = []
    real = tfa._fwd

    def counted(*a, **kw):
        calls.append(a[0].dtype)
        return real(*a, **kw)
    monkeypatch.setattr(tfa, "_fwd", counted)
    cfg = dict(_CFG, use_flash_attention=True)
    batches = _batches(3, 2, 16, 128, seed=2)
    jl, tl, _, tm = _train_both(cfg, batches, learning_rate=1e-3,
                                optimizer_kwargs={"epsilon": 1e-6})
    assert tm.gpt.wte.weight.dtype == torch.float32
    assert calls == [torch.float32] * (3 * _CFG["num_layers"])
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[0] != tl[-1]


@pytest.mark.parametrize("param_dtype", ["bfloat16", None])
def test_head_dim_256_flash_train_steps_match_jax(param_dtype):
    """Two layers of D = 256 (hidden 256, one head) with flash asked for:
    bf16 takes the packed kernels (K1), f32 SDPA's bhd ones (K2); the
    JAX kernels under the interpreter, the port's plain versions on the
    CPU.  2-step loss series."""
    cfg = dict(_CFG, hidden_size=256, num_heads=1, use_flash_attention=True)
    batches = _batches(2, 1, 64, 128, seed=4)
    jl, tl, _, tm = _train_both(cfg, batches, param_dtype=param_dtype,
                                learning_rate=1e-3)
    dt = torch.bfloat16 if param_dtype else torch.float32
    qkv = torch.zeros(1, 64, 3 * 256, dtype=dt)
    assert tm.gpt.blocks[0].attn._packed_flash_ok(qkv, 64) == (
        param_dtype is not None)
    np.testing.assert_allclose(tl, jl, rtol=2e-4 if param_dtype else 1e-5)


def test_step_rng_keys_dropout():
    """The step's ``rng`` seeds its dropout: the same rng repeats the
    loss, another one changes it."""
    cfg = dict(_CFG, hidden_dropout_prob=0.3, attention_dropout_prob=0.3)
    ids, labels = _batches(1, 2, 16, 128, seed=4)[0]
    losses = []
    for rng in (5, 5, 6):
        _, tm = _pair(cfg)
        step, state = make_sharded_train_step(tm, learning_rate=1e-3)
        losses.append(float(step(state, ids, labels, rng=rng)[1]))
    assert losses[0] == losses[1] != losses[2]


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_ignore_index_matches_jax(reduction):
    rng = np.random.RandomState(5)
    logits = rng.randn(12, 10).astype(np.float32)
    labels = rng.randint(0, 10, 12).astype(np.int64)
    labels[[1, 4, 7]] = -100
    ref = np.asarray(jloss.cross_entropy(
        Tensor(jnp.asarray(logits)), Tensor(jnp.asarray(labels)),
        reduction=reduction).numpy())
    out = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                        reduction=reduction).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_model_loss_matches_jax():
    jm, tm = _pair(_CFG)
    ids, labels = _batches(1, 2, 9, 128, seed=7)[0]
    ref = float(jm.loss(Tensor(jnp.asarray(ids)),
                        Tensor(jnp.asarray(labels))).numpy())
    with torch.no_grad():
        out = float(tm.loss(torch.from_numpy(ids), torch.from_numpy(labels)))
    np.testing.assert_allclose(out, ref, rtol=1e-6)
    assert tm.num_params() == jm.num_params()


def test_eager_adam_matches_jax():
    rng = np.random.RandomState(9)
    w0 = rng.randn(6, 5).astype(np.float32)
    grads = [rng.randn(6, 5).astype(np.float32) for _ in range(3)]
    jw = paddle.create_parameter([6, 5], "float32")
    jw._set_value(jnp.asarray(w0))
    jopt = paddle.optimizer.Adam(learning_rate=0.01, parameters=[jw])
    tw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    topt = Adam(learning_rate=0.01, parameters=[tw])
    for g in grads:
        loss = paddle.sum(jw * paddle.to_tensor(g))
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        tw.grad = torch.from_numpy(g)
        topt.step()
        topt.clear_grad()
    np.testing.assert_allclose(tw.detach().numpy(), np.asarray(jw.numpy()),
                               rtol=0, atol=1e-6)
    state = topt.state_dict()
    assert state["@step"] == 3 and set(state) == {"0_moment1", "0_moment2",
                                                 "@step"}
    other = Adam(learning_rate=0.01, parameters=[tw])
    other.set_state_dict(state)
    torch.testing.assert_close(other.state_dict()["0_moment2"],
                               state["0_moment2"])
    other.set_lr(0.5)
    assert other.get_lr() == 0.5


def _jloss_fn(model, params, buffers, batch, rng):
    ids, labels = batch
    logits = jfunctional_call(model, params, (Tensor(ids),), buffers=buffers)
    return (jnp.mean(jloss.fused_softmax_ce_rows(logits, labels))
            + 0.01 * jnp.mean(jnp.square(logits)))


def _tloss_fn(model, params, buffers, batch, rng):
    ids, labels = batch
    logits = torch.func.functional_call(model, (params, buffers), (ids,))
    return (fused_softmax_ce_rows(logits, labels).mean()
            + 0.01 * logits.square().mean())


TRAIN_STEP_OPTIONS = {
    "master_weights": (dict(master_weights=True), {}, {}),
    "lamb": (dict(optimizer="lamb",
                  optimizer_kwargs={"lamb_weight_decay": 0.05}), {}, {}),
    "loss_fn": ({}, dict(loss_fn=_jloss_fn), dict(loss_fn=_tloss_fn)),
    "rule": ({}, dict(rule=jparam_sharding_spec),
             dict(rule=tgpt.param_sharding_spec, mesh={"dp": 1})),
}


@pytest.mark.parametrize("option", sorted(TRAIN_STEP_OPTIONS))
def test_train_step_options_match_jax(option):
    """The options this port runs on one device: 3-step f32 loss series
    at rtol 1e-5 and the updated parameters at atol 1e-5."""
    kw, jkw, tkw = TRAIN_STEP_OPTIONS[option]
    kw = dict(kw)
    okw = dict({"epsilon": 1e-6}, **kw.pop("optimizer_kwargs", {}))
    batches = _batches(3, 2, 16, 128, seed=8)
    jl, tl, jstate, tm = _train_both(_CFG, batches, learning_rate=1e-3,
                                     optimizer_kwargs=okw, jkw=jkw, tkw=tkw,
                                     **kw)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[0] != tl[-1]
    params = state_to_numpy(tm)
    for k, v in jstate["params"].items():
        np.testing.assert_allclose(params[k], np.asarray(v), rtol=0,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("kwargs", [
    dict(mesh={"dp": 2}), dict(mesh={"pp": 2}), dict(recompute=True),
    dict(zero_offload=True), dict(zero_stage=1),
    dict(recompute_policy="full"), dict(pp_microbatches=4),
    dict(sp_mode="ring"), dict(grad_overlap=True), dict(offload_depth=3)])
def test_unported_train_step_options_raise(kwargs):
    _, tm = _pair(_CFG)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 12"):
        make_sharded_train_step(tm, **kwargs)


OPTIMIZER_OPTIONS = {
    "weight_decay": lambda m, nn: dict(weight_decay=0.05),
    "grad_clip": lambda m, nn: dict(grad_clip=nn.ClipGradByGlobalNorm(2.0)),
    "scheduler": lambda m, nn: dict(learning_rate=m.lr.StepDecay(
        0.01, step_size=1, gamma=0.5)),
    "multi_precision": lambda m, nn: dict(multi_precision=True),
}


@pytest.mark.parametrize("option", sorted(OPTIMIZER_OPTIONS))
def test_optimizer_options_match_jax(option):
    """Eager Adam with each option the port used to refuse: 3 steps
    against the JAX package's Adam, f32 atol 1e-6."""
    rng = np.random.RandomState(10)
    w0 = rng.randn(6, 5).astype(np.float32)
    grads = [rng.randn(6, 5).astype(np.float32) * 3 for _ in range(3)]
    jkw = OPTIMIZER_OPTIONS[option](paddle.optimizer, paddle.nn)
    tkw = OPTIMIZER_OPTIONS[option](toptim, tnn)
    jw = paddle.create_parameter([6, 5], "float32")
    jw._set_value(jnp.asarray(w0))
    jopt = paddle.optimizer.Adam(**dict(dict(learning_rate=0.01), **jkw),
                                 parameters=[jw])
    tw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    topt = Adam(**dict(dict(learning_rate=0.01), **tkw), parameters=[tw])
    for g in grads:
        loss = paddle.sum(jw * paddle.to_tensor(g))
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        tw.grad = torch.from_numpy(g)
        topt.step()
        topt.clear_grad()
        if option == "scheduler":
            jkw["learning_rate"].step()
            tkw["learning_rate"].step()
            assert topt.get_lr() == jopt.get_lr()
    np.testing.assert_allclose(tw.detach().numpy(), np.asarray(jw.numpy()),
                               rtol=0, atol=1e-6)


def test_unported_cross_entropy_options_raise():
    """The two options this test once held to a ``NotImplementedError``
    (label smoothing, soft labels) are ported: on the same inputs they
    give the JAX package's value, f32 rtol 1e-6 (``test_torch_layer.py``
    holds every option, with gradients)."""
    x = np.array([[0.5, -1.0, 2.0], [0.1, 0.2, -0.3]], np.float32)
    y = np.array([2, 0], np.int32)
    soft = np.array([[0.2, 0.3, 0.5], [0.6, 0.1, 0.3]], np.float32)
    for label, kw in ((y, {"label_smoothing": 0.1}),
                      (soft, {"soft_label": True})):
        got = cross_entropy(torch.from_numpy(x), torch.from_numpy(label),
                            **kw)
        want = jloss.cross_entropy(Tensor(jnp.asarray(x)),
                                   Tensor(jnp.asarray(label)), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want._value),
                                   rtol=1e-6)
