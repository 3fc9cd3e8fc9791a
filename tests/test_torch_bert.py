"""The BERT / ERNIE family (``models/bert.py``) against the JAX package,
on the JAX model's weights (``load_jax_state``); one 2-layer JAX model
(hidden 32, 4 heads, vocab 128, dropout 0) serves the file.  The JAX
side runs as its own tests run it (``use_flash_attention=False``).

- ``state_dict()`` key sets equal to the JAX package's: 38 keys for the
  2-layer ``BertForPretraining``, the tied word embedding once.
- The trunk under a padding mask (its output, and the unpadded prefix
  unchanged when padded tokens change); ``BertForPretraining.loss`` and
  the gradient of every parameter (the tied matrix's sums both uses;
  at rtol 1e-5 and an atol of 1e-6 times that gradient's largest entry:
  two post-LN layers deep, the f32 reductions of the two libraries drift
  by 1.3e-6 on an embedding gradient whose largest entry is 1.9);
  the ``masked_positions`` head against the full logits; the
  classifier.
- ``bench_ernie``'s custom ``loss_fn`` (masked positions padded to a
  fixed K, pad labels -1, ``fused_softmax_ce_rows``) through both
  ``make_sharded_train_step``s: the 3-step loss series at rtol 1e-5 and
  the final weights at atol 1e-5, Adam's epsilon 1e-6, as in
  ``tests/test_torch_dygraph_gpt.py``.
- The attention dispatch, at hidden 128 and 2 heads (K1's gate takes
  head groups of 128 columns, so no narrower model reaches it): where
  the JAX package's ``BertSelfAttention`` calls the packed kernels (K1,
  ``causal=False``) or SDPA's bhd kernels (K2), the port's does, over
  ``use_flash`` (True / None / False), f32 and bf16, with and without a
  mask, the two flags and two lengths.  A bf16 ``BertForPretraining``
  takes K1 (its plain version on the CPU) once a layer, counted, and
  its hidden states agree with the JAX package's plain bf16 path within
  8 bf16 ulps of each entry's magnitude (floored at 1; measured 4.0 ulps,
  0.0625 at 4.56); under a mask it makes no K1 call and gives the f32
  output JAX's type promotion gives (measured 2.1 ulps).
- The presets and ``Ernie*`` aliases, ``bert_param_sharding_spec`` for
  every parameter name, ``masked_mlm_loss``, ``bert_mlm_pipeline``
  raising citing item 12, entry points that raise without a card.
- ``Model.fit`` on ``Sequential(Linear, BatchNorm1D, Linear)`` trains
  eagerly (``_mutating_layer_types``), with the JAX package's losses and
  running stats; ``jit_compile=True`` names the reason.

f32 at rtol 1e-5 / atol 1e-6 unless a check says otherwise.
"""

import dataclasses
import os
import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_hackathon_tpu as jp
import paddle_hackathon_tpu_torch as tp
from paddle_hackathon_tpu import parallel as jparallel
from paddle_hackathon_tpu.core import random as jrandom
from paddle_hackathon_tpu.core.tensor import Tensor as JTensor
from paddle_hackathon_tpu.incubate.nn import functional as jinc
from paddle_hackathon_tpu.models import bert as jb
from paddle_hackathon_tpu.nn.functional.loss import \
    fused_softmax_ce_rows as jce_rows
from paddle_hackathon_tpu.nn.layer import functional_call as jfcall
from paddle_hackathon_tpu_torch.incubate.nn.kernels import \
    flash_attention_packed as tfap
from paddle_hackathon_tpu_torch.models import bert as tb
from paddle_hackathon_tpu_torch.nn.functional import attention as tattn
from paddle_hackathon_tpu_torch.nn.functional import fused_softmax_ce_rows
from paddle_hackathon_tpu_torch.nn.layer import functional_call
from paddle_hackathon_tpu_torch.parallel import make_sharded_train_step
from paddle_hackathon_tpu_torch.utils import load_jax_state, state_to_numpy

RTOL, ATOL = 1e-5, 1e-6
BF16_ULPS = 8
_CFG = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
            max_position_embeddings=32, type_vocab_size=2,
            hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
            use_flash_attention=False)
_B, _S = 2, 16


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")
    yield


def _close(got, want, what="", rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


@pytest.fixture(scope="module")
def jax_model():
    jp.seed(0)
    jm = jb.BertForPretraining(jb.BertConfig(**_CFG))
    jm.eval()
    return jm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _port(arrays, cls=tb.BertForPretraining, cfg=_CFG, **kw):
    m = cls(tb.BertConfig(**cfg), device="cpu", **kw)
    load_jax_state(m, arrays)
    m.eval()
    return m


def _ids(seed=0, b=_B, s=_S):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 128, (b, s)).astype(np.int32)


def _pad_mask(b=_B, s=_S):
    m = np.ones((b, s), np.int32)
    m[1, s // 2:] = 0
    return m


def test_state_dict_keys_equal_jax(jax_model):
    jm, arrays = jax_model
    tm = _port(arrays)
    keys = list(tm.state_dict())
    assert len(keys) == len(arrays) == 38
    assert sorted(keys) == sorted(arrays)
    assert "bert.embeddings.word_embeddings.weight" in keys
    assert not any("decoder_weight" in k for k in keys)
    assert tm.cls._decoder_weight is tm.bert.embeddings.word_embeddings.weight
    assert tm.cls.decoder_bias.dtype == torch.float32
    assert tm.num_params() == sum(int(np.prod(v.shape))
                                  for v in arrays.values())
    for jcls, tcls in ((jb.BertModel, tb.BertModel),
                       (jb.BertForSequenceClassification,
                        tb.BertForSequenceClassification)):
        jp.seed(1)
        j = jcls(jb.BertConfig(**_CFG))
        assert sorted(tcls(tb.BertConfig(**_CFG), device="cpu")
                      .state_dict()) == sorted(j.state_dict())


def test_trunk_with_padding_mask_matches_jax(jax_model):
    jm, arrays = jax_model
    tm = _port(arrays)
    ids, mask = _ids(), _pad_mask()
    jseq, jpool = jm.bert(jp.to_tensor(ids), attention_mask=mask)
    tseq, tpool = tm.bert(torch.from_numpy(ids),
                          attention_mask=torch.from_numpy(mask))
    _close(tseq.detach(), jseq._value)
    _close(tpool.detach(), jpool._value)
    # padded keys do not reach the unpadded prefix
    ids2 = ids.copy()
    ids2[1, _S // 2:] = (ids2[1, _S // 2:] + 1) % 128
    tseq2, _ = tm.bert(torch.from_numpy(ids2),
                       attention_mask=torch.from_numpy(mask))
    _close(tseq2[1, :_S // 2].detach(), tseq[1, :_S // 2].detach())
    # Paddle Tensors in, Tensors out; token types and positions given
    tt = np.random.RandomState(3).randint(0, 2, (_B, _S)).astype(np.int32)
    pos = np.tile(np.arange(_S)[::-1], (_B, 1)).astype(np.int32)
    out = tm.bert(tp.to_tensor(ids), tp.to_tensor(tt), tp.to_tensor(pos))
    jout = jm.bert(jp.to_tensor(ids), jp.to_tensor(tt), jp.to_tensor(pos))
    assert isinstance(out[0], tp.Tensor)
    _close(out[0].numpy(), jout[0]._value)


def test_pretraining_loss_and_grads_match_jax(jax_model):
    jm, arrays = jax_model
    tm = _port(arrays)
    jm.train(), tm.train()
    ids = _ids(1)
    mlm = np.full((_B, _S), -100)
    mlm[:, 2], mlm[0, 7], mlm[1, 11] = 5, 17, 99
    nsp = np.array([0, 1], np.int64)
    mask = _pad_mask()
    jm.clear_gradients()
    jl = jm.loss(jp.to_tensor(ids), mlm, jp.to_tensor(nsp),
                 attention_mask=mask)
    jl.backward()
    tl = tm.loss(tp.to_tensor(ids), mlm, tp.to_tensor(nsp),
                 attention_mask=tp.to_tensor(mask))
    assert isinstance(tl, tp.Tensor)
    tl.backward()
    _close(float(tl.detach()), float(jl))
    jparams = dict(jm.named_parameters())
    for name, p in tm.named_parameters():
        want = np.asarray(jparams[name].grad._value)
        _close(p.grad, want, name,
               atol=ATOL * max(1.0, float(np.abs(want).max())))
    jm.eval()


def test_masked_positions_head_matches_full_logits(jax_model):
    jm, arrays = jax_model
    tm = _port(arrays)
    ids = _ids(4)
    pos = np.array([1, 5, 17, 30], np.int32)          # flat b*s indices
    full, nsp = tm(torch.from_numpy(ids))
    rows, nsp2 = tm(torch.from_numpy(ids),
                    masked_positions=torch.from_numpy(pos))
    assert tuple(full.shape) == (_B, _S, 128) and tuple(rows.shape) == (4,
                                                                        128)
    _close(rows.detach(), full.reshape(-1, 128)[pos].detach())
    _close(nsp2.detach(), nsp.detach())
    jrows, _ = jm(JTensor(jnp.asarray(ids)),
                  masked_positions=JTensor(jnp.asarray(pos)))
    _close(rows.detach(), jrows._value)
    jfull, _ = jm(JTensor(jnp.asarray(ids)))
    _close(full.detach(), jfull._value)


def test_sequence_classification_matches_jax(jax_model):
    _, arrays = jax_model
    jp.seed(5)
    jc = jb.ErnieForSequenceClassification(jb.BertConfig(**_CFG),
                                           num_classes=3)
    jc.eval()
    tc = _port({k: np.asarray(v.numpy()) for k, v in jc.state_dict().items()},
               cls=tb.ErnieForSequenceClassification, num_classes=3)
    ids, mask = _ids(6), _pad_mask()
    _close(tc(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask))
           .detach(), jc(jp.to_tensor(ids), attention_mask=mask)._value)


def _bench_batch(b, s, vocab, seed):
    """``bench_ernie``'s masked-positions batch: 15% masking, K padded to
    a multiple of 32 here (512 in the bench), pad labels -1."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (b, s)).astype(np.int32)
    lab = rng.randint(0, vocab, (b, s))
    m = rng.rand(b, s) < 0.15
    flat = np.where(m.reshape(-1))[0]
    K = -(-int(b * s * 0.16) // 32) * 32
    pos = np.zeros(K, np.int32)
    pos[:len(flat)] = flat
    glab = np.full(K, -1, np.int32)
    glab[:len(flat)] = lab.reshape(-1)[flat]
    return (ids, pos), glab


def _jloss_fn(model, params, buffers, batch_, rng_key):
    # bench.py's bench_ernie loss_fn, as it is there
    (b_ids, b_pos), b_labels = batch_
    with jrandom.rng_scope(rng_key):
        out = jfcall(model, params, (JTensor(b_ids),),
                     kwargs={"masked_positions": JTensor(b_pos)},
                     buffers=dict(buffers))
    lg = out[0]
    lg = lg._value if isinstance(lg, JTensor) else lg
    mask = b_labels >= 0
    rows = jce_rows(lg, jnp.maximum(b_labels, 0))
    rows = jnp.where(mask, rows, 0.0)
    return jnp.sum(rows) / jnp.maximum(jnp.sum(mask), 1)


def _tloss_fn(model, params, buffers, batch_, rng):
    (ids, pos), labels = batch_
    lg = functional_call(model, params, (ids,),
                         kwargs={"masked_positions": pos},
                         buffers=buffers)[0]
    mask = labels >= 0
    rows = fused_softmax_ce_rows(lg, labels.clamp_min(0))
    rows = torch.where(mask, rows, torch.zeros_like(rows))
    return rows.sum() / mask.sum().clamp_min(1)


def test_bench_ernie_loss_fn_train_steps_match_jax(jax_model):
    _, arrays = jax_model
    jp.seed(0)
    jm = jb.BertForPretraining(jb.BertConfig(**_CFG))
    jm.set_state_dict(arrays)
    tm = _port(arrays)
    kw = dict(learning_rate=1e-3, grad_clip_norm=1.0,
              optimizer_kwargs={"epsilon": 1e-6})
    mesh = jparallel.create_mesh({"dp": 1}, devices=jax.devices()[:1])
    jstep, jstate = jparallel.make_sharded_train_step(
        jm, mesh, zero_stage=0, loss_fn=_jloss_fn, **kw)
    tstep, tstate = make_sharded_train_step(tm, loss_fn=_tloss_fn, **kw)
    jl, tl = [], []
    for i in range(3):
        (ids, pos), labels = _bench_batch(4, _S, 128, seed=i)
        jstate, loss = jstep(jstate, (jnp.asarray(ids), jnp.asarray(pos)),
                             jnp.asarray(labels), jax.random.PRNGKey(i))
        jl.append(float(loss))
        tstate, loss = tstep(tstate, (ids, pos), labels)
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
    assert tl[0] != tl[-1]
    params = state_to_numpy(tm)
    assert set(params) == set(jstate["params"])
    for k, v in jstate["params"].items():
        np.testing.assert_allclose(params[k], np.asarray(v), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


# -- the attention dispatch ---------------------------------------------------
_WIDE = dict(_CFG, hidden_size=128, num_heads=2)     # D = 64: K1's gate


def _dispatch_spies(monkeypatch):
    """Record every packed (K1) and bhd (K2) flash call on both sides.
    The K1 spies return zeros of the output's shape (the dispatch, not the
    values, is under test); the K2 spies record the gate's answer and
    raise its ValueError, so the plain composition runs."""
    calls = {"jax": [], "port": []}

    def packed(side, zeros):
        def spy(qkv, num_heads, causal=True, sm_scale=None, dropout_p=0.0,
                seed=None):
            b, s, hd3 = qkv.shape
            calls[side].append(("k1", bool(causal), s))
            return zeros(b, s, hd3 // 3, qkv.dtype)
        return spy

    def bhd(side, gate):
        def spy(q, k, v, causal=False, sm_scale=None, dropout_p=0.0,
                seed=None):
            calls[side].append(("k2", bool(gate(q.shape[1], k.shape[1])),
                                q.shape[1]))
            raise ValueError("spy")
        return spy

    from paddle_hackathon_tpu.incubate.nn.kernels import \
        flash_attention as jfa
    from paddle_hackathon_tpu_torch.incubate.nn.kernels import \
        flash_attention as tfa
    monkeypatch.setattr(jinc, "flash_attention_qkv_packed", packed(
        "jax", lambda b, s, h, dt: jp.zeros([b, s, h], dtype=dt)))
    monkeypatch.setattr(tb, "flash_attention_qkv_packed", packed(
        "port", lambda b, s, h, dt: torch.zeros(b, s, h, dtype=dt)))
    monkeypatch.setattr(jinc, "flash_attention_bshd", bhd("jax",
                                                          jfa.supported))
    monkeypatch.setattr(tattn, "flash_attention_bshd", bhd("port",
                                                           tfa.supported))
    return calls


@pytest.mark.parametrize("flags", [
    {"use_fused_kernels": True, "flash_attention_min_seqlen": 1024},
    {"use_fused_kernels": True, "flash_attention_min_seqlen": 16},
    {"use_fused_kernels": False, "flash_attention_min_seqlen": 16}],
    ids=["default", "min16", "unfused"])
def test_attention_dispatch_matches_jax(monkeypatch, flags):
    calls = _dispatch_spies(monkeypatch)
    names = list(flags)
    old = (jp.get_flags(names), tp.get_flags(names))
    jp.set_flags(flags), tp.set_flags(flags)
    try:
        seen = []
        for use_flash in (True, None, False):
            cfg = dict(_WIDE, use_flash_attention=use_flash)
            jp.seed(2)
            ja = jb.BertSelfAttention(jb.BertConfig(**cfg))
            ta = tb.BertSelfAttention(tb.BertConfig(**cfg), device="cpu")
            for dt in ("float32", "bfloat16"):
                ja_ = ja.astype(dt)
                ta_ = ta.astype(dt)
                for s in (16, 12):
                    x = np.random.RandomState(s).randn(1, s, 128).astype(
                        np.float32)
                    for masked in (False, True):
                        mask = None
                        if masked:
                            mask = np.zeros((1, 1, 1, s), np.float32)
                            mask[..., -2:] = -1e30
                        n = len(calls["jax"]), len(calls["port"])
                        ja_(jp.to_tensor(x).astype(dt),
                            None if mask is None else jp.to_tensor(mask))
                        ta_(torch.tensor(x).to(getattr(torch, dt)),
                            None if mask is None else torch.tensor(mask))
                        j, t = calls["jax"][n[0]:], calls["port"][n[1]:]
                        assert j == t, (use_flash, dt, s, masked, j, t)
                        seen += t
        if flags["use_fused_kernels"]:
            assert ("k1", False, 16) in seen    # bidirectional K1 taken
        if flags["flash_attention_min_seqlen"] == 16 and \
                flags["use_fused_kernels"]:
            assert ("k2", True, 16) in seen     # f32 took K2's gate
    finally:
        jp.set_flags(old[0]), tp.set_flags(old[1])


def _bf16_ulps(got, want):
    """The largest error in bf16 ulps of each reference entry's magnitude
    (floored at 1)."""
    ref = torch.from_numpy(np.array(want._value, np.float32))
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1))) - 7)
    return float(((got.detach().float() - ref).abs() / ulp).max())


def test_bf16_encoder_takes_k1_where_jax_does(monkeypatch):
    """A bf16 ``BertForPretraining`` with flash asked for: K1 (its plain
    version on the CPU) once a layer, non-causal; the JAX package's test
    for the packed path agrees; the hidden states against the JAX plain
    bf16 path.  Under a padding mask: no K1, the plain composition in f32
    (the f32 mask promotes), as in JAX."""
    jp.seed(8)
    jm = jb.BertForPretraining(jb.BertConfig(**_WIDE))
    arrays = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    jm = jm.bfloat16()
    jm.eval()
    tm = _port(arrays, cfg=dict(_WIDE, use_flash_attention=True),
               dtype="bfloat16")
    assert tm.cls.decoder_bias.dtype == torch.float32
    ids = _ids(9, s=32)
    qkv = jnp.zeros((_B, 32, 384), jnp.bfloat16)
    jflash = jb.BertSelfAttention(jb.BertConfig(
        **dict(_WIDE, use_flash_attention=True)))
    assert jflash._packed_flash_ok(JTensor(qkv), 32)
    calls = []
    real = tfap.flash_packed_fwd_ref

    def counted(qkv, heads, causal, *a, **kw):
        calls.append(causal)
        return real(qkv, heads, causal, *a, **kw)
    monkeypatch.setattr(tfap, "flash_packed_fwd_ref", counted)
    tseq, _ = tm.bert(torch.from_numpy(ids))
    jseq, _ = jm.bert(jp.to_tensor(ids))
    assert calls == [False] * _WIDE["num_layers"]
    assert tseq.dtype == torch.bfloat16
    assert _bf16_ulps(tseq, jseq) <= BF16_ULPS
    # under a padding mask: the plain composition, f32 after it
    mask = _pad_mask(s=32)
    tseq, _ = tm.bert(torch.from_numpy(ids),
                      attention_mask=torch.from_numpy(mask))
    jseq, _ = jm.bert(jp.to_tensor(ids), attention_mask=mask)
    assert calls == [False] * _WIDE["num_layers"]
    assert tseq.dtype == torch.float32 and \
        str(jseq._value.dtype) == "float32"
    assert _bf16_ulps(tseq, jseq) <= BF16_ULPS


# -- surface ------------------------------------------------------------------
def test_presets_and_aliases_match_jax():
    for name in jb._PRESETS:
        assert dataclasses.asdict(tb.bert_config(name)) == \
            dataclasses.asdict(jb.bert_config(name)), name
    assert dataclasses.asdict(tb.ernie_config(
        "ernie-3.0-base-zh", hidden_dropout_prob=0.0)) == dataclasses.asdict(
        jb.ernie_config("ernie-3.0-base-zh", hidden_dropout_prob=0.0))
    assert tb.bert_config("ernie-1.0").hidden_act == "relu"
    assert tb.BertConfig().ffn_size == 3072
    assert tb.ErnieModel is tb.BertModel
    assert tb.ErnieForPretraining is tb.BertForPretraining
    assert tb.ErnieForSequenceClassification is \
        tb.BertForSequenceClassification
    for name in ("BertConfig", "BertModel", "BertForPretraining",
                 "BertForSequenceClassification", "ErnieModel",
                 "ErnieForPretraining", "ErnieForSequenceClassification",
                 "bert_config", "ernie_config", "masked_mlm_loss",
                 "bert_param_sharding_spec", "bert_mlm_pipeline"):
        assert getattr(tp.models, name) is getattr(tb, name)
        assert hasattr(jp.models, name)


def test_param_sharding_spec_matches_jax(jax_model):
    _, arrays = jax_model
    for name, v in arrays.items():
        assert tb.bert_param_sharding_spec(name, v.shape) == \
            jb.bert_param_sharding_spec(name, v.shape), name


def test_masked_mlm_loss_matches_jax():
    rng = np.random.RandomState(3)
    logits = rng.randn(2, 5, 11).astype(np.float32)
    labels = rng.randint(0, 11, (2, 5))
    labels[0, 1], labels[1, 3] = -100, -100
    want = jb.masked_mlm_loss(jnp.asarray(logits), jnp.asarray(labels))
    got = tb.masked_mlm_loss(torch.from_numpy(logits),
                             torch.from_numpy(labels))
    _close(float(got), float(want))


def test_pipeline_and_entry_points_raise():
    with pytest.raises(NotImplementedError, match="item 12"):
        tb.bert_mlm_pipeline(tb.BertConfig(**_CFG))
    att = tb.BertSelfAttention(tb.BertConfig(**_CFG), device="cpu")
    att.seq_parallel_axis = "sp"
    with pytest.raises(NotImplementedError, match="item 12"):
        att(torch.zeros(1, 4, 32))
    if not torch.cuda.is_available():
        for cls in (tb.BertModel, tb.BertForPretraining,
                    tb.BertForSequenceClassification):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                cls(tb.BertConfig(**_CFG))


def test_new_modules_are_under_the_import_check():
    """The grep of ``tests/test_torch_native_serving.py`` walks every
    ``.py`` file of the port; this slice's modules are among them and
    import nothing of JAX or the JAX package."""
    root = os.path.join(os.path.dirname(__file__), "..",
                        "paddle_hackathon_tpu_torch")
    pat = re.compile(r"^\s*(import|from)\s+(jax|paddle_hackathon_tpu)\b",
                     re.M)
    for rel in ("models/bert.py", "nn/functional/common.py",
                "nn/functional/norm.py", "nn/layers/common.py",
                "nn/layers/norm.py", "nn/layers/transformer.py",
                "nn/utils/__init__.py"):
        with open(os.path.join(root, rel)) as f:
            assert not pat.search(f.read()), rel


# -- Model.fit on a network with BatchNorm -----------------------------------
def _bn_fit(mod, arrays):
    x = np.random.RandomState(0).randn(32, 10).astype(np.float32)
    y = (x.sum(1) > 0).astype(np.int64)

    class Toy(mod.io.Dataset):
        def __len__(self):
            return len(x)

        def __getitem__(self, i):
            return x[i], y[i]

    nn = mod.nn
    net = nn.Sequential(nn.Linear(10, 8), nn.BatchNorm1D(8),
                        nn.Linear(8, 2))
    net.set_state_dict(arrays)
    m = mod.Model(net)
    m.prepare(optimizer=mod.optimizer.Adam(learning_rate=1e-2,
                                           parameters=net.parameters()),
              loss=nn.CrossEntropyLoss())
    losses = []

    class Spy(mod.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            losses.append(float(np.asarray(logs["loss"]).reshape(-1)[0]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m.fit(Toy(), epochs=1, batch_size=8, shuffle=False, verbose=0,
              callbacks=[Spy()])
    stats = {k: np.asarray(getattr(v, "_value", v))
             for k, v in net.state_dict().items() if k.startswith("1._")}
    return m, losses, stats, Toy()


def test_batch_norm_network_fits_eagerly_as_jax_does():
    from paddle_hackathon_tpu_torch.hapi.compiled import (
        _mutating_layer_types, unsupported_reason)
    assert _mutating_layer_types() == (tp.nn.layers.norm._BatchNormBase,
                                       tp.nn.SpectralNorm)
    jp.seed(0)
    jnet = jp.nn.Sequential(jp.nn.Linear(10, 8), jp.nn.BatchNorm1D(8),
                            jp.nn.Linear(8, 2))
    arrays = {k: np.asarray(v.numpy()) for k, v in jnet.state_dict().items()}
    jm, jl, jstats, _ = _bn_fit(jp, arrays)
    tm, tl, tstats, toy = _bn_fit(tp, arrays)
    assert "buffers" in unsupported_reason(tm)
    assert tm._fit_used_compiled is False and jm._fit_used_compiled is False
    assert len(tl) == len(jl) == 4 and np.isfinite(tl).all()
    _close(tl, jl, "losses")
    assert sorted(tstats) == ["1._mean", "1._variance"]
    for k in tstats:
        _close(tstats[k], jstats[k], k)
    with pytest.raises(ValueError, match="buffers"):
        tm.fit(toy, epochs=1, batch_size=8, verbose=0, jit_compile=True)
