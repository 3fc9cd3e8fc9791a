"""The port's train steps (``paddle_hackathon_tpu_torch/parallel/api.py``)
against the JAX package's on a 2-layer GPT with shared weights.

- ``make_functional_train_step`` with AdamW (biases and layer norms
  spared by ``apply_decay_param_fun``), ``LinearWarmup`` over
  ``CosineAnnealingDecay`` and ``ClipGradByGlobalNorm``: plain,
  ``merge_k=2`` and ``scan_batch`` (3 steps over a stacked batch); loss
  series at rtol 1e-5 and parameters at atol 1e-5, f32.
- ``make_sharded_train_step`` with lars, with a custom ``loss_fn`` over a
  tuple batch ``(ids, masked_positions)``, with ``rule=param_sharding_spec``
  on ``{"dp": 1}`` (3-step f32 series at rtol 1e-5), and with f32 master
  weights over bf16 parameters (rtol 2e-4: the two packages round bf16
  matrix products at other points, as ``test_torch_train.py`` explains).
- ``param_sharding_spec`` returns the JAX package's tuples.

Adam's epsilon is 1e-6 where the gradients come from a summed backward
(see ``test_torch_train.py``)."""

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
from paddle_hackathon_tpu.nn.functional import loss as jloss
from paddle_hackathon_tpu.nn.layer import functional_call as jfunctional_call
from paddle_hackathon_tpu.parallel.api import \
    make_functional_train_step as jmake_functional_train_step
from paddle_hackathon_tpu_torch import nn as tnn
from paddle_hackathon_tpu_torch import optimizer as toptim
from paddle_hackathon_tpu_torch.models import gpt as tgpt
from paddle_hackathon_tpu_torch.nn.functional import fused_softmax_ce_rows
from paddle_hackathon_tpu_torch.parallel import (make_functional_train_step,
                                                 make_sharded_train_step)
from paddle_hackathon_tpu_torch.utils import load_jax_state, state_to_numpy

_CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            max_position_embeddings=128, hidden_dropout_prob=0.0,
            attention_dropout_prob=0.0, use_flash_attention=False)


def _pair(seed=11):
    paddle.seed(seed)
    jm = JGPT(JConfig(**_CFG))
    arrays = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = load_jax_state(tgpt.GPTForCausalLM(tgpt.GPTConfig(**_CFG),
                                            device="cpu"), arrays)
    return jm, tm


def _ids(rng, *shape):
    return rng.randint(0, _CFG["vocab_size"], shape).astype(np.int32)


def _spared(name):
    return name.endswith(".bias") or ".ln" in name or "ln_f" in name


# -- make_functional_train_step -------------------------------------------

def _functional_both(merge_k=1, scan_batch=False):
    jm, tm = _pair()
    jnamed, tnamed = list(jm.named_parameters()), list(tm.named_parameters())
    order = [n for n, _ in tnamed]
    struct = {p.name: n for n, p in jnamed}

    def sched(m):
        return m.LinearWarmup(m.CosineAnnealingDecay(2e-3, T_max=8),
                              warmup_steps=2, start_lr=5e-4, end_lr=2e-3)
    jsched, tsched = sched(paddle.optimizer.lr), sched(toptim.lr)
    jopt = paddle.optimizer.AdamW(
        learning_rate=jsched, epsilon=1e-6, weight_decay=0.1,
        parameters=[p for _, p in jnamed],
        apply_decay_param_fun=lambda n: not _spared(struct[n]),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    topt = toptim.AdamW(
        learning_rate=tsched, epsilon=1e-6, weight_decay=0.1,
        parameters=tnamed, apply_decay_param_fun=lambda n: not _spared(n),
        grad_clip=tnn.ClipGradByGlobalNorm(1.0))
    _, jbuf = jm.functional_state()

    def jgrads_of(p, xs, ys, step):
        def f(pp):
            logits = jfunctional_call(jm, pp, (Tensor(xs),), buffers=jbuf)
            return jnp.mean(jloss.fused_softmax_ce_rows(logits, ys))
        return jax.value_and_grad(f)(p)

    def tgrads_of(p, xs, ys, step):
        ps = {k: v.detach().requires_grad_() for k, v in p.items()}
        logits = torch.func.functional_call(tm, ps, (xs.long(),))
        loss = fused_softmax_ce_rows(logits, ys).mean()
        return loss.detach(), dict(zip(ps, torch.autograd.grad(
            loss, list(ps.values()))))

    jplist = [p for _, p in jnamed]
    tplist = [p for _, p in tnamed]
    jstep = jmake_functional_train_step(jopt, jplist, order, jgrads_of,
                                        merge_k=merge_k,
                                        scan_batch=scan_batch)
    tstep = make_functional_train_step(topt, tplist, order, tgrads_of,
                                       merge_k=merge_k,
                                       scan_batch=scan_batch)
    jp = {k: p._value for k, p in jnamed}
    tp = {k: p.detach() for k, p in tnamed}
    js, ts = jopt.functional_state(jplist), topt.functional_state(tplist)
    jt, tt = jnp.int32(0), 0
    rng = np.random.RandomState(3)
    jl, tl = [], []
    calls = 1 if scan_batch else 3
    lead = (3,) if scan_batch else ()
    for _ in range(calls):
        xs, ys = _ids(rng, *lead, 4, 16), _ids(rng, *lead, 4, 16)
        lr = tsched()
        assert lr == jsched()
        jp, js, jt, jloss_ = jstep(jp, js, jt, jnp.float32(lr),
                                   (jnp.asarray(xs), jnp.asarray(ys)))
        tp, ts, tt, tloss_ = tstep(tp, ts, tt, lr, (torch.from_numpy(xs),
                                                    torch.from_numpy(ys)))
        jl.extend(np.atleast_1d(np.asarray(jloss_)).tolist())
        tl.extend(np.atleast_1d(tloss_.numpy()).tolist())
        jsched.step()
        tsched.step()
    assert int(jt) == tt == 3
    return jl, tl, jp, tp, topt, tplist, ts


@pytest.mark.parametrize("merge_k,scan_batch", [(1, False), (2, False),
                                                (1, True)])
def test_functional_train_step_matches_jax(merge_k, scan_batch):
    jl, tl, jp, tp, topt, tplist, ts = _functional_both(merge_k, scan_batch)
    assert len(tl) == 3
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[0] != tl[-1]
    for k, v in jp.items():
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(v), rtol=0,
                                   atol=1e-5, err_msg=k)
    # the live parameters did not move; the states load back
    assert not torch.equal(tplist[0].detach(), tp[next(iter(tp))])
    topt.load_functional_state(tplist, ts, step_count=3)
    assert topt.state_dict()["@step"] == 3


def test_functional_train_step_refuses_zero_options():
    with pytest.raises(NotImplementedError, match="item 12"):
        make_functional_train_step(None, [], [], None, shard_info=object())
    with pytest.raises(NotImplementedError, match="item 12"):
        make_functional_train_step(None, [], [], None, grad_overlap=True)


# -- make_sharded_train_step's one-device options ---------------------------

def _sharded_both(batches, param_dtype=None, jkw=(), tkw=(), **kw):
    jm, tm = _pair()
    mesh = jparallel.create_mesh({"dp": 1}, devices=jax.devices()[:1])
    jstep, jstate = jparallel.make_sharded_train_step(
        jm, mesh, zero_stage=0, param_dtype=param_dtype, **kw, **dict(jkw))
    tstep, tstate = make_sharded_train_step(tm, param_dtype=param_dtype,
                                            **kw, **dict(tkw))
    jl, tl = [], []
    for i, (ids, labels) in enumerate(batches):
        jids = jax.tree.map(jnp.asarray, ids)
        jstate, loss = jstep(jstate, jids, jnp.asarray(labels),
                             jax.random.PRNGKey(i))
        jl.append(float(loss))
        tstate, loss = tstep(tstate, ids, labels)
        tl.append(float(loss))
    return jl, tl, jstate, tstate, tm


def _plain_batches(n, seed):
    rng = np.random.RandomState(seed)
    return [(_ids(rng, 2, 16), _ids(rng, 2, 16)) for _ in range(n)]


def _check_f32(jl, tl, jstate, tm):
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[0] != tl[-1]
    params = state_to_numpy(tm)
    for k, v in jstate["params"].items():
        np.testing.assert_allclose(params[k], np.asarray(v), rtol=0,
                                   atol=1e-5, err_msg=k)


def test_sharded_step_lars_matches_jax():
    jl, tl, jstate, tstate, tm = _sharded_both(
        _plain_batches(3, 1), learning_rate=5.0, optimizer="lars",
        optimizer_kwargs={"lars_weight_decay": 0.01})
    _check_f32(jl, tl, jstate, tm)
    # lars keeps one slot, the velocity
    assert set(tstate["opt_state"]["gpt.wte.weight"]) == {"m"}
    for k, st in jstate["opt_state"].items():
        np.testing.assert_allclose(tstate["opt_state"][k]["m"].numpy(),
                                   np.asarray(st["m"]), rtol=0, atol=1e-5)


def _jmasked_loss(model, params, buffers, batch, rng):
    (ids, pos), labels = batch
    logits = jfunctional_call(model, params, (Tensor(ids),), buffers=buffers)
    picked = logits[jnp.arange(ids.shape[0])[:, None], pos]
    return jnp.mean(jloss.fused_softmax_ce_rows(picked, labels))


def _tmasked_loss(model, params, buffers, batch, rng):
    (ids, pos), labels = batch
    logits = torch.func.functional_call(model, (params, buffers),
                                        (ids.long(),))
    picked = logits[torch.arange(ids.shape[0])[:, None], pos.long()]
    return fused_softmax_ce_rows(picked, labels).mean()


def test_sharded_step_custom_loss_over_tuple_batch_matches_jax():
    """The loss at 5 masked positions a row, the positions passed as data
    beside the ids (the BERT pretraining heads' contract)."""
    rng = np.random.RandomState(2)
    batches = [((_ids(rng, 2, 16),
                 np.stack([rng.choice(16, 5, replace=False)
                           for _ in range(2)]).astype(np.int32)),
                _ids(rng, 2, 5)) for _ in range(3)]
    jl, tl, jstate, _, tm = _sharded_both(
        batches, learning_rate=1e-3, optimizer_kwargs={"epsilon": 1e-6},
        jkw=dict(loss_fn=_jmasked_loss), tkw=dict(loss_fn=_tmasked_loss))
    _check_f32(jl, tl, jstate, tm)


def test_sharded_step_with_rule_matches_jax():
    jl, tl, jstate, _, tm = _sharded_both(
        _plain_batches(3, 4), learning_rate=1e-3,
        optimizer_kwargs={"epsilon": 1e-6},
        jkw=dict(rule=jparam_sharding_spec),
        tkw=dict(rule=tgpt.param_sharding_spec, mesh={"dp": 1}))
    _check_f32(jl, tl, jstate, tm)


def test_sharded_step_bf16_master_weights_match_jax():
    jl, tl, jstate, tstate, tm = _sharded_both(
        _plain_batches(3, 5), param_dtype="bfloat16", master_weights=True,
        learning_rate=1e-3)
    np.testing.assert_allclose(tl, jl, rtol=2e-4)
    assert tl[-1] < tl[0]
    for k, p in tstate["params"].items():
        master = tstate["opt_state"][k]["master"]
        assert p.dtype == torch.bfloat16 and master.dtype == torch.float32
        assert torch.equal(p.detach(), master.to(torch.bfloat16))
    # the masters carry what the bf16 parameters round away (per-entry
    # masters are not compared with JAX's: an entry whose gradient is
    # noise, as the key bias's, takes Adam steps of random sign)
    assert any(not torch.equal(m["master"], p.detach().float())
               for m, p in zip(tstate["opt_state"].values(),
                               tstate["params"].values()))


def test_param_sharding_spec_matches_jax():
    jm, _ = _pair()
    names = [n for n, _ in jm.named_parameters()] + [
        "gpt.blocks.0.attn.qkv_proj.weight_scale",
        "gpt.blocks.0.mlp.fc_out.weight_scale", "gpt.blocks.1.mlp.w1",
        "gpt.blocks.1.mlp.b1", "gpt.blocks.1.mlp.w2", "gpt.blocks.1.mlp.b2",
        "gpt.blocks.1.mlp.gate.weight", "other.weight"]
    for n in names:
        assert tgpt.param_sharding_spec(n, (4, 4)) == \
            tuple(jparam_sharding_spec(n, (4, 4))), n
