"""The port's optimizers, clips and loss against the JAX package's.

- Every optimizer class over 3 eager steps from shared numpy weights and
  gradients, each weight-decay kind (none, float, ``L1Decay``,
  ``L2Decay``; AdamW, Lamb and Lars their own decoupled or trust-ratio
  decay) and each clip (none, by value, by norm, by global norm) at f32
  atol 1e-6.  The gradients are given, not summed, so Adam's default
  epsilon 1e-8 has no summation noise to magnify.
- AdamW's ``apply_decay_param_fun`` and Lamb's
  ``exclude_from_weight_decay_fn`` on a small GPT's parameters: the JAX
  parameters' own names (``param_N``) are mapped to the structured names
  through the two models' ``named_parameters()`` order; Lars's
  ``exclude_from_weight_decay`` on parameters named on both sides.
- The multi-tensor Adam/AdamW update equals the per-tensor rule bit for
  bit (f32 and bf16 parameters, bf16 moments, per-parameter rates).
- ``functional_update`` with per-parameter rates against the JAX one.
- ``fused_softmax_ce_rows``: f32 values and gradients against JAX at
  1e-6; bf16 gradients bit for bit those of the unchunked autograd form
  over many chunks; no f32 ``[rows, V]`` tensor saved for the backward.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_hackathon_tpu as paddle
from paddle_hackathon_tpu import optimizer as jopt
from paddle_hackathon_tpu.models.gpt import GPTConfig as JConfig
from paddle_hackathon_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_hackathon_tpu.nn import clip as jclip
from paddle_hackathon_tpu.nn.functional import loss as jloss
from paddle_hackathon_tpu_torch import optimizer as topt
from paddle_hackathon_tpu_torch import regularizer
from paddle_hackathon_tpu_torch.models import gpt as tgpt
from paddle_hackathon_tpu_torch.nn import clip as tclip
from paddle_hackathon_tpu_torch.nn.functional import loss as tloss
from paddle_hackathon_tpu_torch.optimizer import Optimizer
from paddle_hackathon_tpu_torch.utils import load_jax_state

SHAPES = {"fc.weight": (6, 5), "fc.bias": (5,), "ln.weight": (3, 4)}

COUPLED = {   # rule -> (constructor, its keyword arguments)
    "SGD": dict(learning_rate=0.1),
    "Momentum": dict(learning_rate=0.1, momentum=0.8, use_nesterov=True),
    "Adam": dict(learning_rate=0.01),
    "Adagrad": dict(learning_rate=0.1),
    "RMSProp": dict(learning_rate=0.01, momentum=0.5, centered=True),
    "Adadelta": dict(learning_rate=0.5),
    "Adamax": dict(learning_rate=0.01),
}
OWN_DECAY = {
    "AdamW": dict(learning_rate=0.01, weight_decay=0.05),
    "Lamb": dict(learning_rate=0.01, lamb_weight_decay=0.05),
    "Lars": dict(learning_rate=0.1, lars_weight_decay=0.01),
}
DECAYS = [None, "float", "L1", "L2"]
CLIPS = [None, "value", "norm", "global"]


def _decay(mod, kind):
    if kind == "float":
        return 0.02
    if kind is None:
        return None
    return getattr(mod, f"{kind}Decay")(0.02)


def _clip(mod, kind):
    if kind is None:
        return None
    return {"value": lambda: mod.ClipGradByValue(0.5),
            "norm": lambda: mod.ClipGradByNorm(1.5),
            "global": lambda: mod.ClipGradByGlobalNorm(2.0)}[kind]()


def _data(seed):
    rng = np.random.RandomState(seed)
    w0 = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(3)]
    return w0, grads


def _eager_both(cls_name, kwargs, decay=None, clip=None, seed=0):
    """3 eager steps of ``cls_name`` in both packages; returns the final
    weights (JAX, port) by name and the two optimizers."""
    w0, grads = _data(seed)
    jps = {}
    for k, w in w0.items():
        jps[k] = paddle.create_parameter(list(w.shape), "float32", name=k)
        jps[k]._set_value(jnp.asarray(w))
    tps = {k: torch.nn.Parameter(torch.from_numpy(w.copy()))
           for k, w in w0.items()}
    jkw, tkw = dict(kwargs), dict(kwargs)
    if decay is not None:
        jkw["weight_decay"] = _decay(jopt, decay)
        tkw["weight_decay"] = _decay(topt, decay)
    if clip is not None:
        jkw["grad_clip"] = _clip(jclip, clip)
        tkw["grad_clip"] = _clip(tclip, clip)
    jo = getattr(jopt, cls_name)(parameters=list(jps.values()), **jkw)
    to = getattr(topt, cls_name)(parameters=list(tps.items()), **tkw)
    for gs in grads:
        loss = sum(paddle.sum(jps[k] * paddle.to_tensor(g))
                   for k, g in gs.items())
        loss.backward()
        jo.step()
        jo.clear_grad()
        for k, g in gs.items():
            tps[k].grad = torch.from_numpy(g.copy())
        to.step()
        to.clear_grad()
    return ({k: np.asarray(p.numpy()) for k, p in jps.items()},
            {k: p.detach().numpy() for k, p in tps.items()}, jo, to)


CASES = ([(n, d, c) for n in COUPLED for d, c in zip(DECAYS, CLIPS)]
         + [(n, "own", c) for n in OWN_DECAY for c in CLIPS])


@pytest.mark.parametrize("name,decay,clip", CASES,
                         ids=[f"{n}-{d}-{c}" for n, d, c in CASES])
def test_optimizer_three_steps_match_jax(name, decay, clip):
    kwargs = COUPLED.get(name) or OWN_DECAY[name]
    jw, tw, jo, to = _eager_both(name, kwargs,
                                 None if decay == "own" else decay, clip)
    for k in SHAPES:
        np.testing.assert_allclose(tw[k], jw[k], rtol=0, atol=1e-6,
                                   err_msg=k)
        assert not np.array_equal(tw[k], _data(0)[0][k]), k
    # the same slots under the same keys, the same step count
    js, ts = jo.state_dict(), to.state_dict()
    assert set(ts) == set(js) and ts["@step"] == 3
    for key in js:
        if key != "@step":
            np.testing.assert_allclose(ts[key].numpy(),
                                       np.asarray(js[key].numpy()),
                                       rtol=0, atol=1e-5, err_msg=key)


def test_larsmomentum_alias_and_regularizer_exports():
    assert topt.LarsMomentum is topt.Lars
    assert regularizer.L2Decay is topt.L2Decay
    from paddle_hackathon_tpu_torch.optimizer import optimizers as tops
    from paddle_hackathon_tpu.optimizer import optimizers as jops
    assert tops.LAMB_DEFAULTS == jops.LAMB_DEFAULTS
    assert tops.LARS_DEFAULTS == jops.LARS_DEFAULTS


def test_bad_options_raise():
    p = torch.nn.Parameter(torch.zeros(3))
    with pytest.raises(TypeError, match="grad_clip"):
        topt.Adam(parameters=[p], grad_clip=object())
    with pytest.raises(ValueError, match="parameters"):
        topt.Adam()
    opt = topt.Adam(parameters=[p])
    with pytest.raises(NotImplementedError, match="item 12"):
        opt.functional_update([p], [p], opt.functional_state([p]), 0.1, 1,
                              shard_info=object())
    p.grad = torch.ones(3)
    with pytest.raises(ValueError, match="named_parameters"):
        topt.AdamW(parameters=[p], apply_decay_param_fun=bool).step()
    with pytest.raises(ValueError, match="named_parameters"):
        topt.Lars(parameters=[p], exclude_from_weight_decay=["b"]).step()


# -- per-parameter decay rules on a small GPT's parameters ------------------

_CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
            max_position_embeddings=32, hidden_dropout_prob=0.0,
            attention_dropout_prob=0.0, use_flash_attention=False)


def _gpt_pair(seed=5):
    paddle.seed(seed)
    jm = JGPT(JConfig(**_CFG))
    arrays = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = load_jax_state(tgpt.GPTForCausalLM(tgpt.GPTConfig(**_CFG),
                                            device="cpu"), arrays)
    return jm, tm


def _no_decay(name):
    return name.endswith(".bias") or ".ln" in name or "ln_f" in name


def _decay_rules():
    """(class, JAX kwargs of the structured-name map, port kwargs)."""
    def adamw(struct, tparams):
        return ("AdamW", dict(learning_rate=0.01, weight_decay=0.1,
                              apply_decay_param_fun=lambda n: not _no_decay(
                                  struct[n])),
                dict(learning_rate=0.01, weight_decay=0.1,
                     apply_decay_param_fun=lambda n: not _no_decay(n)))

    def lamb(struct, tparams):
        excluded = {id(p) for n, p in tparams if _no_decay(n)}
        return ("Lamb", dict(learning_rate=0.01, lamb_weight_decay=0.1,
                             exclude_from_weight_decay_fn=lambda p: _no_decay(
                                 struct[p.name])),
                dict(learning_rate=0.01, lamb_weight_decay=0.1,
                     exclude_from_weight_decay_fn=lambda p: id(p) in excluded))
    return {"AdamW": adamw, "Lamb": lamb}


@pytest.mark.parametrize("rule", ["AdamW", "Lamb"])
def test_per_parameter_decay_rule_matches_jax(rule):
    jm, tm = _gpt_pair()
    jnamed = list(jm.named_parameters())
    tnamed = list(tm.named_parameters())
    assert [n for n, _ in jnamed] == [n for n, _ in tnamed]
    struct = {p.name: n for n, p in jnamed}
    cls, jkw, tkw = _decay_rules()[rule](struct, tnamed)
    jo = getattr(jopt, cls)(parameters=[p for _, p in jnamed],
                            grad_clip=jclip.ClipGradByGlobalNorm(1.0), **jkw)
    to = getattr(topt, cls)(parameters=tnamed,
                            grad_clip=tclip.ClipGradByGlobalNorm(1.0), **tkw)
    rng = np.random.RandomState(1)
    for _ in range(3):
        gs = {n: rng.randn(*p.shape).astype(np.float32) for n, p in tnamed}
        loss = sum(paddle.sum(p * paddle.to_tensor(gs[n])) for n, p in jnamed)
        loss.backward()
        jo.step()
        jo.clear_grad()
        for n, p in tnamed:
            p.grad = torch.from_numpy(gs[n])
        to.step()
        to.clear_grad()
    for (n, jp), (_, tp) in zip(jnamed, tnamed):
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp.numpy()),
                                   rtol=0, atol=1e-6, err_msg=n)
    # the rule decays some parameters and spares others
    flags = to._decay_flags([p for _, p in tnamed], len(tnamed))
    assert any(flags) and not all(flags)
    assert [f for f in flags] == [not _no_decay(n) for n, _ in tnamed]


def test_lars_exclusion_by_name_matches_jax():
    """Lars matches substrings of the names: JAX parameters named at
    creation, port parameters given as (name, tensor) pairs."""
    jw, tw, jo, to = _eager_both(
        "Lars", dict(learning_rate=0.1, lars_weight_decay=0.05,
                     exclude_from_weight_decay=["bias", "ln."]))
    for k in SHAPES:
        np.testing.assert_allclose(tw[k], jw[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    assert to._decay_flags(to._parameter_list, 3) == (True, False, False)


# -- the multi-tensor update against the per-tensor rule --------------------

def _bits(t):
    return t.view({torch.float32: torch.int32, torch.bfloat16: torch.int16,
                   torch.float16: torch.int16}[t.dtype])


@pytest.mark.parametrize("cls,dtype,moment_dtype", [
    ("Adam", torch.float32, None), ("Adam", torch.bfloat16, None),
    ("Adam", torch.bfloat16, "bfloat16"), ("AdamW", torch.float32, None),
    ("AdamW", torch.bfloat16, "bfloat16")])
def test_multi_tensor_update_is_bit_identical_to_per_tensor(cls, dtype,
                                                            moment_dtype):
    rng = np.random.RandomState(2)
    shapes = [(33, 17), (17,), (4, 5, 6), (1,), (64, 8)]
    named = [(f"p{i}" + (".bias" if len(s) == 1 else ".weight"),
              torch.nn.Parameter(torch.from_numpy(
                  rng.randn(*s).astype(np.float32)).to(dtype)))
             for i, s in enumerate(shapes)]
    kw = dict(learning_rate=3e-3, epsilon=1e-8, moment_dtype=moment_dtype,
              parameters=named, grad_clip=tclip.ClipGradByGlobalNorm(5.0))
    if cls == "AdamW":
        kw.update(weight_decay=0.1,
                  apply_decay_param_fun=lambda n: n.endswith(".weight"))
    opt = getattr(topt, cls)(**kw)
    params = [p for _, p in named]
    vals = [p.detach().clone() for p in params]
    # moments from an earlier step, so that beta * m counts
    states = [{k: torch.from_numpy(np.abs(rng.randn(*p.shape)).astype(
        np.float32) * (1e-2 if k == "moment2" else 1.0)).to(s[k].dtype)
        for k in s} for p, s in zip(params, opt.functional_state(params))]
    grads = [torch.from_numpy(rng.randn(*p.shape).astype(np.float32)).to(
        dtype) for p in params]
    lrs = (1.0, 0.5, 2.0, 1.0, 0.3)
    multi = opt.functional_update(vals, grads, states, 3e-3, 4, lrs, params)
    single = Optimizer._update_all(opt, vals, grads, states, 3e-3, 4, lrs,
                                   params)
    for a, b in zip(multi[0], single[0]):
        assert a.dtype == dtype
        assert torch.equal(_bits(a), _bits(b))
    for sa, sb in zip(multi[1], single[1]):
        for k in sa:
            assert torch.equal(_bits(sa[k]), _bits(sb[k])), k
    # the eager step takes the same path and writes the values in place
    for p, g in zip(params, grads):
        p.grad = g
    for p, s in zip(params, states):
        opt._accumulators[id(p)] = s
    opt._step_count = 3
    opt.step()
    same = Optimizer._update_all(opt, vals, grads, states, 3e-3, 4,
                                 (1.0,) * 5, params)[0]
    for p, b in zip(params, same):
        assert torch.equal(_bits(p.detach()), _bits(b))


def test_functional_update_with_param_lrs_matches_jax():
    w0, grads = _data(4)
    names = list(SHAPES)
    lrs = (1.0, 0.25, 3.0)
    jps = [paddle.create_parameter(list(w0[k].shape), "float32", name=k)
           for k in names]
    jo = jopt.AdamW(learning_rate=0.01, parameters=jps, weight_decay=0.1,
                    apply_decay_param_fun=lambda n: n != "fc.bias")
    tps = [torch.nn.Parameter(torch.from_numpy(w0[k].copy())) for k in names]
    to = topt.AdamW(learning_rate=0.01, parameters=list(zip(names, tps)),
                    weight_decay=0.1,
                    apply_decay_param_fun=lambda n: n != "fc.bias")
    jvals = [jnp.asarray(w0[k]) for k in names]
    tvals = [torch.from_numpy(w0[k].copy()) for k in names]
    js, ts = jo.functional_state(jps), to.functional_state(tps)
    for t, gs in enumerate(grads, 1):
        jvals, js = jo.functional_update(
            jvals, [jnp.asarray(gs[k]) for k in names], js,
            jnp.float32(0.01), jnp.int32(t), lrs, params=jps)
        tvals, ts = to.functional_update(
            tvals, [torch.from_numpy(gs[k]) for k in names], ts, 0.01, t,
            lrs, params=tps)
    for k, jv, tv in zip(names, jvals, tvals):
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0,
                                   atol=1e-6, err_msg=k)
    to.load_functional_state(tps, ts, step_count=3)
    state = to.state_dict()
    assert state["@step"] == 3 and "fc.bias_moment2" in state
    # the live parameters did not move: the functional update is pure
    np.testing.assert_array_equal(tps[0].detach().numpy(), w0[names[0]])


def test_minimize_and_clear_gradients():
    p = torch.nn.Parameter(torch.ones(4))
    opt = topt.SGD(learning_rate=0.5, parameters=[p])
    assert opt.minimize((p * 2.0).sum()) == (None, None)
    torch.testing.assert_close(p.detach(), torch.zeros(4))
    assert p.grad is None
    p.grad = torch.ones(4)
    opt.clear_gradients(set_to_zero=True)
    assert torch.equal(p.grad, torch.zeros(4))


# -- the chunked loss ------------------------------------------------------

def _logits(rows, vocab, dtype, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, vocab).astype(np.float32) * 4
    y = rng.randint(0, vocab, rows).astype(np.int64)
    return x, y, torch.from_numpy(x).to(dtype).requires_grad_()


def test_chunked_loss_f32_matches_jax(monkeypatch):
    monkeypatch.setattr(tloss, "_CHUNK_BYTES", 4 * 97 * 7)  # 7 rows a chunk
    x, y, tx = _logits(50, 97, torch.float32)
    out = tloss.fused_softmax_ce_rows(tx, torch.from_numpy(y))
    cot = np.random.RandomState(1).randn(50).astype(np.float32)
    out.backward(torch.from_numpy(cot))
    import jax
    ref, vjp = jax.vjp(lambda a: jloss.fused_softmax_ce_rows(
        a, jnp.asarray(y)), jnp.asarray(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(tx.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(cot))[0]),
                               rtol=0, atol=1e-6)
    # axis other than the last: the same rows
    x3 = np.moveaxis(x.reshape(5, 10, 97), 2, 1)
    out3 = tloss.fused_softmax_ce_rows(torch.from_numpy(x3.copy()),
                                       torch.from_numpy(y.reshape(5, 10)),
                                       axis=1)
    torch.testing.assert_close(out3.reshape(-1), out.detach(), rtol=0,
                               atol=0)


def _unchunked(logits, labels):
    """The port's loss before the chunking, as autograd differentiates
    it."""
    lse = torch.logsumexp(logits.float(), dim=-1)
    return lse - logits.gather(-1, labels[:, None]).squeeze(-1).float()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_chunked_loss_grads_bit_equal_unchunked(monkeypatch, dtype):
    monkeypatch.setattr(tloss, "_CHUNK_BYTES", 4 * 301 * 5)
    x, y, tx = _logits(123, 301, dtype, seed=3)
    labels = torch.from_numpy(y)
    ux = tx.detach().clone().requires_grad_()
    out = tloss.fused_softmax_ce_rows(tx, labels)
    ref = _unchunked(ux, labels)
    assert torch.equal(out, ref.detach())
    out.mean().backward()
    ref.mean().backward()
    assert tx.grad.dtype == dtype
    assert torch.equal(_bits(tx.grad), _bits(ux.grad))


def test_chunked_loss_saves_no_f32_copy():
    rows, vocab = 64, 512
    _, y, tx = _logits(rows, vocab, torch.bfloat16)
    saved = []

    def pack(t):
        saved.append((t.dtype, tuple(t.shape)))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = tloss.cross_entropy(tx, torch.from_numpy(y))
    assert (torch.bfloat16, (rows, vocab)) in saved
    assert (torch.float32, (rows, vocab)) not in saved
    loss.backward()
    assert tx.grad.dtype == torch.bfloat16
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        saved.clear()
        _unchunked(tx, torch.from_numpy(y))
    assert (torch.float32, (rows, vocab)) in saved   # the old form did
