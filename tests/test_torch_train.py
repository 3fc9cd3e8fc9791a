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
- ``cross_entropy`` with ``ignore_index``, eager ``Adam.step()``, and the
  options the port refuses."""

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
from paddle_hackathon_tpu.nn.functional import loss as jloss
from paddle_hackathon_tpu_torch.models import gpt as tgpt
from paddle_hackathon_tpu_torch.nn.functional import cross_entropy
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


def _train_both(cfg, batches, param_dtype=None, **kw):
    jm, tm = _pair(cfg)
    mesh = jparallel.create_mesh({"dp": 1}, devices=jax.devices()[:1])
    jstep, jstate = jparallel.make_sharded_train_step(
        jm, mesh, zero_stage=0, param_dtype=param_dtype, **kw)
    tstep, tstate = make_sharded_train_step(tm, param_dtype=param_dtype,
                                            **kw)
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


@pytest.mark.parametrize("kwargs", [
    dict(mesh={"dp": 2}), dict(mesh={"pp": 2}), dict(recompute=True),
    dict(zero_offload=True), dict(master_weights=True),
    dict(optimizer="lamb"), dict(loss_fn=lambda *a: 0.0),
    dict(rule=lambda *a: None), dict(zero_stage=1),
    dict(recompute_policy="full"), dict(pp_microbatches=4),
    dict(sp_mode="ring"), dict(grad_overlap=True), dict(offload_depth=3)])
def test_unported_train_step_options_raise(kwargs):
    _, tm = _pair(_CFG)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_sharded_train_step(tm, **kwargs)


@pytest.mark.parametrize("kwargs", [
    dict(weight_decay=0.01), dict(grad_clip=object()),
    dict(learning_rate=lambda: 0.1), dict(multi_precision=True)])
def test_unported_optimizer_options_raise(kwargs):
    p = torch.nn.Parameter(torch.zeros(3))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Adam(parameters=[p], **kwargs)


def test_unported_cross_entropy_options_raise():
    x, y = torch.zeros(2, 3), torch.zeros(2, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cross_entropy(x, y, label_smoothing=0.1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cross_entropy(x, torch.zeros(2, 3), soft_label=True)
