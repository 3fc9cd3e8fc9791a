"""``Model.fit`` in the port (``hapi/``) against the JAX package's.

- The slice as a whole: a 2-layer GPT (hidden 64, 2 heads, vocab 128,
  s = 32, dropout 0) on the JAX package's weights (``load_jax_state``),
  fitted 2 epochs of 3 batches with Adam (epsilon 1e-6, for the reason
  ``tests/test_torch_dygraph_gpt.py`` gives) and
  ``ClipGradByGlobalNorm(1.0)`` on ``CrossEntropyLoss``, eagerly in both
  packages: the loss series at f32 rtol 1e-5 / atol 1e-6, the final
  weights at rtol 1e-5 / atol 1e-5.  In the port the K-step trainer
  (``jit_compile=True``) at K = 1 equals the eager fit, and K = 4 equals
  K = 1, bit for bit on the CPU.
- On a small MLP: the fallback decisions (``unsupported_reason``) and the
  warn-once fallback of a forward that reads device values on the host,
  as in ``tests/test_hapi_compiled_fit.py``; callbacks, ``EarlyStopping``
  and ``LRScheduler``; ``evaluate`` and ``predict``; ``paddle.save`` in one
  package and ``paddle.load`` in the other; ``summary`` and ``flops``; and
  the options the port refuses, each naming its ROADMAP item.
"""

import warnings

import numpy as np
import pytest
import torch

import paddle_hackathon_tpu as jp
import paddle_hackathon_tpu_torch as tp
from paddle_hackathon_tpu.models.gpt import GPTConfig as JConfig
from paddle_hackathon_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_hackathon_tpu_torch.hapi import compiled as tcompiled
from paddle_hackathon_tpu_torch.models import gpt as tgpt
from paddle_hackathon_tpu_torch.utils import load_jax_state

RTOL, ATOL = 1e-5, 1e-6
_CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=2,
            max_position_embeddings=64, hidden_dropout_prob=0.0,
            attention_dropout_prob=0.0, use_flash_attention=False)
_B, _S, _N = 4, 32, 12          # 3 batches an epoch


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")


def _rows(mod):
    """An ``io.Dataset`` of (ids, labels) rows, made with numpy."""
    rng = np.random.RandomState(7)
    ids = rng.randint(0, 128, (_N, _S)).astype(np.int32)
    labels = rng.randint(0, 128, (_N, _S)).astype(np.int32)

    class Rows(mod.io.Dataset):
        def __len__(self):
            return _N

        def __getitem__(self, i):
            return ids[i], labels[i]
    return Rows()


@pytest.fixture(scope="module")
def arrays():
    jp.seed(5)
    jm = JGPT(JConfig(**_CFG))
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _gpt_model(mod, arrays):
    if mod is jp:
        net = JGPT(JConfig(**_CFG))
        net.set_state_dict(arrays)
    else:
        net = load_jax_state(tgpt.GPTForCausalLM(tgpt.GPTConfig(**_CFG),
                                                 device="cpu"), arrays)
    m = mod.Model(net)
    m.prepare(optimizer=mod.optimizer.Adam(
        learning_rate=1e-3, epsilon=1e-6, parameters=net.parameters(),
        grad_clip=mod.nn.ClipGradByGlobalNorm(1.0)),
        loss=mod.nn.CrossEntropyLoss())
    return m


def _spy(mod, out):
    class Spy(mod.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            out.append(float(logs["loss"]))
    return Spy()


def _fit(mod, m, **kw):
    series = []
    m.fit(_rows(mod), epochs=2, batch_size=_B, verbose=0, shuffle=False,
          callbacks=[_spy(mod, series)], **kw)
    return series


def _weights(m):
    return {k: np.asarray(v.numpy()) for k, v in
            m.network.state_dict().items()}


@pytest.fixture(scope="module")
def fits(arrays):
    """The JAX package's eager fit, and the port's eager and K-step fits,
    from the same weights and rows."""
    tp.set_device("cpu")
    out = {}
    jm = _gpt_model(jp, arrays)
    out["jax"] = (_fit(jp, jm, jit_compile=False), _weights(jm))
    for name, kw in (("eager", dict(jit_compile=False)),
                     ("k1", dict(jit_compile=True, steps_per_execution=1)),
                     ("k4", dict(jit_compile=True, steps_per_execution=4))):
        m = _gpt_model(tp, arrays)
        series = _fit(tp, m, **kw)
        out[name] = (series, _weights(m), m)
    return out


def test_eager_fit_matches_jax(fits, arrays):
    jl, jw = fits["jax"]
    tl, tw, m = fits["eager"]
    assert len(tl) == len(jl) == 6
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    assert not m._fit_used_compiled
    assert not np.allclose(tw["gpt.wte.weight"], arrays["gpt.wte.weight"])
    for name, v in jw.items():
        np.testing.assert_allclose(tw[name], v, rtol=RTOL, atol=1e-5,
                                   err_msg=name)
    assert m._optimizer._step_count == 6


@pytest.mark.parametrize("pair", [("k1", "eager"), ("k4", "k1")])
def test_k_step_trainer_is_bit_exact(fits, pair):
    a, b = fits[pair[0]], fits[pair[1]]
    assert a[2]._fit_used_compiled
    assert a[0] == b[0]
    for name, v in b[1].items():
        np.testing.assert_array_equal(a[1][name], v, err_msg=name)
    # the accumulators and the step count went back to the optimizer
    assert a[2]._optimizer._step_count == 6
    sa, sb = a[2]._optimizer.state_dict(), b[2]._optimizer.state_dict()
    assert sorted(sa) == sorted(sb)
    for k, v in sb.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(sa[k], v), k


# -- the MLP cases -----------------------------------------------------------

def _toy(mod, n=64, d=10):
    rng = np.random.RandomState(0)
    x = rng.randn(n, d).astype(np.float32)
    y = (x.sum(1) > 0).astype(np.int64)

    class Toy(mod.io.Dataset):
        def __len__(self):
            return n

        def __getitem__(self, i):
            return x[i], y[i]
    return Toy()


def _mlp(mod, lr=1e-2, metrics=None, opt=None, sched=None):
    """The JAX package's toy MLP; the port's takes the JAX weights."""
    jp.seed(7)
    jnet = jp.nn.Sequential(jp.nn.Linear(10, 32), jp.nn.ReLU(),
                            jp.nn.Linear(32, 2))
    net = jnet
    if mod is tp:
        net = tp.nn.Sequential(tp.nn.Linear(10, 32), tp.nn.ReLU(),
                               tp.nn.Linear(32, 2))
        net.set_state_dict({k: np.asarray(v.numpy())
                            for k, v in jnet.state_dict().items()})
    m = mod.Model(net)
    rate = sched(mod) if sched is not None else lr
    m.prepare(optimizer=(opt or mod.optimizer.Adam)(
        learning_rate=rate, parameters=net.parameters()),
        loss=mod.nn.CrossEntropyLoss(), metrics=metrics)
    return m


_REASONS = {
    "metrics": (lambda mod: _mlp(mod, metrics=mod.metric.Accuracy()), {}),
    "accumulate": (lambda mod: _mlp(mod),
                   {"accumulate_grad_batches": 4}),
    "no_loss": (lambda mod: _no_loss(mod), {}),
    "foreign_params": (lambda mod: _foreign(mod), {}),
    "ok": (lambda mod: _mlp(mod), {}),
}


def _no_loss(mod):
    m = _mlp(mod)
    m._loss = None
    return m


def _foreign(mod):
    m = _mlp(mod)
    extra = mod.nn.Linear(2, 2)
    m._optimizer._parameter_list = (list(m._optimizer._parameter_list)
                                    + list(extra.parameters()))
    return m


@pytest.mark.parametrize("case", sorted(_REASONS))
def test_fallback_decisions_match_jax(case):
    from paddle_hackathon_tpu.hapi.compiled import \
        unsupported_reason as jreason
    make, kw = _REASONS[case]
    assert tcompiled.unsupported_reason(make(tp), **kw) == \
        jreason(make(jp), **kw)


def test_jit_compile_true_surfaces_the_reason():
    m = _mlp(tp, metrics=tp.metric.Accuracy())
    with pytest.raises(ValueError, match="metrics"):
        m.fit(_toy(tp, n=16), epochs=1, batch_size=8, verbose=0,
              jit_compile=True)


def _branchy(mod):
    class Branchy(mod.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = mod.nn.Linear(10, 2)

        def forward(self, x):
            if float(x.numpy().mean()) > 100:  # data-dependent branch
                return self.fc(x) * 2
            return self.fc(x)
    mod.seed(0)
    net = Branchy()
    m = mod.Model(net)
    m.prepare(optimizer=mod.optimizer.SGD(learning_rate=1e-2,
                                          parameters=net.parameters()),
              loss=mod.nn.CrossEntropyLoss())
    return m


@pytest.mark.parametrize("mod", [jp, tp], ids=["jax", "port"])
def test_host_read_in_forward_falls_back_and_warns_once(mod):
    m = _branchy(mod)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        logs = m.fit(_toy(mod, n=32), epochs=2, batch_size=8, verbose=0)
    msgs = [str(w.message) for w in rec
            if issubclass(w.category, RuntimeWarning)
            and "falling back to eager" in str(w.message)]
    assert len(msgs) == 1
    assert m._fit_used_compiled is False
    assert np.isfinite(logs["loss"])
    assert m._optimizer._step_count == 8   # every batch trained once


def test_callbacks_see_every_step_and_stop_mid_window():
    seen = []

    class Spy(tp.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            seen.append((step, logs.get("loss")))
            if step == 5:
                self.model.stop_training = True

    m = _mlp(tp)
    m.fit(_toy(tp), epochs=1, batch_size=8, verbose=0, shuffle=False,
          jit_compile=True, steps_per_execution=2, callbacks=[Spy()])
    assert m._fit_used_compiled
    assert [s for s, _ in seen] == [0, 1, 2, 3, 4, 5]
    # log_freq boundaries come as floats, the rest as 0-d device tensors
    assert isinstance(seen[0][1], float)
    assert isinstance(seen[1][1], torch.Tensor) and seen[1][1].dim() == 0


def _step_decay(mod):
    return mod.optimizer.lr.StepDecay(learning_rate=0.05, step_size=3,
                                      gamma=0.5)


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "k_step"])
def test_lr_scheduler_and_early_stopping_match_jax(jit):
    """``LRScheduler(by_step=True)`` steps the schedule each batch and
    ``EarlyStopping`` on the eval loss stops at the same epoch; the loss
    series and the final learning rate equal the JAX package's eager
    fit's."""
    out = {}
    for mod in (jp, tp):
        m = _mlp(mod, sched=_step_decay)
        series = []
        cbs = [_spy(mod, series),
               mod.callbacks.LRScheduler(by_step=True, by_epoch=False),
               mod.callbacks.EarlyStopping(monitor="loss", patience=0,
                                           verbose=0, min_delta=10.0)]
        m.fit(_toy(mod, n=48), eval_data=_toy(mod, n=16), epochs=5,
              batch_size=8, verbose=0, shuffle=False, callbacks=cbs,
              jit_compile=jit if mod is tp else False)
        out[mod] = (series, m._optimizer.get_lr())
    jl, jlr = out[jp]
    tl, tlr = out[tp]
    assert len(tl) == len(jl) == 12    # stopped after the second epoch
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    assert tlr == jlr


def test_evaluate_predict_and_metrics_match_jax():
    res = {}
    for mod in (jp, tp):
        m = _mlp(mod, metrics=mod.metric.Accuracy())
        logs = m.fit(_toy(mod), epochs=1, batch_size=8, verbose=0,
                     shuffle=False)
        ev = m.evaluate(_toy(mod, n=24), batch_size=8, verbose=0)
        pred = m.predict(_toy(mod, n=24), batch_size=8, stack_outputs=True)
        res[mod] = (logs, ev, pred)
    (jl, je, jpred), (tl, te, tpred) = res[jp], res[tp]
    assert set(tl) == set(jl) == {"loss", "acc"}
    assert tl["acc"] == jl["acc"] and te["acc"] == je["acc"]
    np.testing.assert_allclose(te["loss"], je["loss"], rtol=RTOL,
                               atol=ATOL)
    assert len(tpred) == len(jpred) == 1 and tpred[0].shape == (24, 2)
    np.testing.assert_allclose(tpred[0], np.asarray(jpred[0]), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_save_in_one_package_load_in_the_other(tmp_path, direction):
    src, dst = (jp, tp) if direction == "jax_to_port" else (tp, jp)
    m = _mlp(src)
    m.fit(_toy(src, n=16), epochs=1, batch_size=8, verbose=0)
    path = str(tmp_path / "ckpt" / "mlp")
    m.save(path)
    blob = {"w": src.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3)),
            "meta": {"epoch": 3, "names": ["a", "b"]},
            "seq": (src.to_tensor(np.array([1, 2], np.int32)), 1.5)}
    src.save(blob, str(tmp_path / "blob.pd"))
    back = dst.load(str(tmp_path / "blob.pd"))
    assert back["meta"] == {"epoch": 3, "names": ["a", "b"]}
    np.testing.assert_array_equal(np.asarray(back["w"].numpy()),
                                  np.arange(6, dtype=np.float32)
                                  .reshape(2, 3))
    assert isinstance(back["seq"], tuple) and back["seq"][1] == 1.5
    np.testing.assert_array_equal(np.asarray(back["seq"][0].numpy()),
                                  [1, 2])
    fresh = _mlp(dst)
    fresh.load(path)
    want = _weights(m)
    got = _weights(fresh)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert fresh._optimizer._step_count == 2
    ev_src = m.evaluate(_toy(src, n=16), batch_size=8, verbose=0)
    ev_dst = fresh.evaluate(_toy(dst, n=16), batch_size=8, verbose=0)
    np.testing.assert_allclose(ev_dst["loss"], ev_src["loss"], rtol=RTOL,
                               atol=ATOL)


def test_bf16_round_trips_in_the_port(tmp_path):
    """bf16 is stored as its uint16 bit view with the dtype beside it; the
    JAX package's own raw two-byte bf16 arrays load here as bf16."""
    t = tp.to_tensor(np.array([1.5, -2.25, 3e-3], np.float32)).astype(
        "bfloat16")
    tp.save({"t": t}, str(tmp_path / "a.pd"))
    back = tp.load(str(tmp_path / "a.pd"))["t"]
    assert back._value.dtype == torch.bfloat16
    assert torch.equal(back._value, t._value)
    jt = jp.to_tensor(np.array([1.5, -2.25, 3e-3], np.float32)).astype(
        "bfloat16")
    jp.save({"t": jt}, str(tmp_path / "j.pd"))
    jback = tp.load(str(tmp_path / "j.pd"))["t"]
    assert jback._value.dtype == torch.bfloat16
    assert torch.equal(jback._value, t._value)


def test_summary_and_flops_match_jax(arrays, capsys):
    tnet = load_jax_state(tgpt.GPTForCausalLM(tgpt.GPTConfig(**_CFG),
                                              device="cpu"), arrays)
    jnet = JGPT(JConfig(**_CFG))
    got = tp.summary(tnet)
    want = jp.summary(jnet)
    assert got == want
    assert got["total_params"] == sum(p.numel() for _, p in
                                      tnet.named_parameters())
    assert tp.Model(tnet).summary() == want
    tm, jm = _mlp(tp), _mlp(jp)
    assert tp.flops(tm.network, input_size=[4, 10]) == \
        jp.flops(jm.network, input_size=[4, 10]) == 2 * 4 * (10 * 32 + 32 * 2)
    capsys.readouterr()


_REFUSED = {
    "checkpoint": (dict(checkpoint="ckpt_dir"), "item 12"),
    "zero_stage": (dict(zero_stage=1), "item 12"),
    "zero_offload": (dict(zero_offload=True), "item 12"),
    "grad_overlap": (dict(grad_overlap=True), "item 12"),
}


@pytest.mark.parametrize("case", sorted(_REFUSED))
def test_options_not_ported_raise_with_their_item(case):
    kw, item = _REFUSED[case]
    with pytest.raises(NotImplementedError, match=item):
        _mlp(tp).fit(_toy(tp, n=16), epochs=1, batch_size=8, verbose=0,
                     **kw)


@pytest.mark.parametrize("call,item", [
    ("checkpoint_flat", "item 12"), ("cost_model", "item 13"),
    ("static_cost_data", "item 13")])
def test_trainer_and_cost_model_refusals(call, item):
    with pytest.raises(NotImplementedError, match=item):
        if call == "checkpoint_flat":
            tcompiled.CompiledTrainer(_mlp(tp)).checkpoint_flat()
        elif call == "cost_model":
            tp.cost_model.CostModel()
        else:
            tp.cost_model.CostModel.static_cost_data()


def test_cost_model_accounting(monkeypatch, arrays):
    """``train_flops_per_token`` is the JAX package's ``6 N + 12 L h s``
    (the tied embedding counted once); ``device_peak_flops`` reads the
    override, and has no entry for a machine without a card."""
    from paddle_hackathon_tpu.cost_model import train_flops_per_token as jf
    tnet = load_jax_state(tgpt.GPTForCausalLM(tgpt.GPTConfig(**_CFG),
                                              device="cpu"), arrays)
    jnet = JGPT(JConfig(**_CFG))
    assert tp.cost_model.train_flops_per_token(tnet, seqlen=_S) == \
        jf(jnet, seqlen=_S)
    monkeypatch.setenv("PHT_PEAK_FLOPS", "123e12")
    assert tp.cost_model.device_peak_flops() == 123e12
    monkeypatch.delenv("PHT_PEAK_FLOPS")
    if not torch.cuda.is_available():
        assert tp.cost_model.device_peak_flops() is None


def test_fit_raises_without_a_place(monkeypatch):
    """With no place set and no card, the loader's batches have nowhere to
    land: fit raises instead of running on the CPU."""
    from paddle_hackathon_tpu_torch.core import device as pdevice
    m = _mlp(tp)
    monkeypatch.setattr(pdevice, "_current", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.fit(_toy(tp, n=16), epochs=1, batch_size=8, verbose=0)


def test_top_level_surface():
    """The names the JAX package's ``__init__`` and ``nn`` give this
    slice's modules, in the port too."""
    from paddle_hackathon_tpu.nn.functional import activation as ja
    from paddle_hackathon_tpu.nn.functional import loss as jl
    from paddle_hackathon_tpu.nn.layers import activation as jla
    from paddle_hackathon_tpu.nn.layers import loss as jll
    for name in ("Model", "hapi", "io", "metric", "callbacks", "save",
                 "load", "summary", "flops", "framework", "cost_model"):
        assert hasattr(jp, name) and hasattr(tp, name), name
    assert tp.Model is tp.hapi.Model and tp.save is tp.framework.save
    for mod, ns in ((jla, tp.nn), (jll, tp.nn), (ja, tp.nn.functional),
                    (jl, tp.nn.functional)):
        names = [n for n, v in vars(mod).items() if not n.startswith("_")
                 and callable(v) and getattr(v, "__module__", "")
                 == mod.__name__]
        assert names
        for n in names:
            assert hasattr(ns, n), n
    for name in ("Callback", "ProgBarLogger", "ModelCheckpoint", "VisualDL",
                 "LRScheduler", "EarlyStopping", "ReduceLROnPlateau"):
        assert hasattr(tp.callbacks, name), name


def test_k_step_telemetry_windows():
    """The K-step fit sets the step-time, throughput and phase series at
    its fetches; a window counts the steps of the supersteps dispatched in
    it (K = 4, ``log_freq`` 2: the window closing at the epoch end holds
    the second superstep's 4 steps)."""
    from paddle_hackathon_tpu_torch.observability import metrics as obs
    reg = obs.get_registry()
    hist = reg.histogram("train_step_seconds", "", unit="s").labels(
        path="hapi_compiled")
    before = hist.count
    m = _mlp(tp)
    m.fit(_toy(tp), epochs=1, batch_size=8, verbose=0, shuffle=False,
          jit_compile=True, steps_per_execution=4, log_freq=2)
    # fetches at steps 0, 2, 4, 6 and the epoch end: the first opens the
    # first window, the step-2 fetch (inside superstep 0) closes nothing
    # new, step 4's closes superstep 1
    assert hist.count - before >= 1
    tps = reg.gauge("train_tokens_per_sec", "").labels(
        path="hapi_compiled")._value
    assert tps > 0
    for ph in ("dispatch", "host_wait", "device"):
        assert reg.gauge("train_phase_seconds_per_step", "").labels(
            path="hapi_compiled", phase=ph)._value >= 0
