"""The port's QAT layers (``paddle_hackathon_tpu_torch.nn.quant``:
``quant_layers.py``, ``functional_layers.py``, ``weight_only.py``'s QAT
export) against the JAX package's, in f32 on the CPU.

- Fake-quant forwards and straight-through gradients at 1e-6, and the
  observers' buffers (moving averages over 5 training steps, frozen in
  eval).
- ``QuantizedLinear`` forward, gradients and observers, and the cases of
  ``tests/test_quant_serving.py``'s QAT export (learned scales, the
  per-tensor broadcast, the refusal of per-input-channel scales):
  ``convert_to_weight_only`` gives the JAX package's int8 weights and f32
  scales bit for bit.
- A 2-layer GPT (hidden 64) with its 8 projections wrapped, weights and
  observer buffers carried across by ``load_jax_state``: the same logits
  and observers over training-mode forwards, the same converted layers,
  and the converted model saved and served by the port's engine
  token-exact against the JAX engine on the JAX-converted model.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_hackathon_tpu as paddle
from paddle_hackathon_tpu.core.tensor import Tensor
from paddle_hackathon_tpu.inference.serving import ServingEngine as JEngine
from paddle_hackathon_tpu.models.gpt import GPTConfig as JConfig
from paddle_hackathon_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_hackathon_tpu.nn.layers.common import Linear as JLinear
from paddle_hackathon_tpu.nn.quant import functional_layers as JFL
from paddle_hackathon_tpu.nn.quant import quant_layers as jql
from paddle_hackathon_tpu.nn.quant import weight_only as jwo
from paddle_hackathon_tpu_torch.inference import (ServingEngine,
                                                  load_for_serving,
                                                  save_for_serving)
from paddle_hackathon_tpu_torch.models import gpt as tgpt
from paddle_hackathon_tpu_torch.nn import Linear as TLinear
from paddle_hackathon_tpu_torch.nn import quant as tq
from paddle_hackathon_tpu_torch.nn.quant import functional_layers as TFL
from paddle_hackathon_tpu_torch.utils import load_jax_state, state_to_numpy

TOL = dict(rtol=1e-6, atol=1e-6)
_CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            max_position_embeddings=128, hidden_dropout_prob=0.0,
            attention_dropout_prob=0.0, use_flash_attention=False)
_PROJ = (("attn", "qkv_proj"), ("attn", "out_proj"), ("mlp", "fc_in"),
         ("mlp", "fc_out"))


def _x(shape, seed, scale=3.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _np(t):
    return np.asarray(t.numpy()) if not isinstance(t, torch.Tensor) \
        else t.detach().cpu().numpy()


def _jax_fwd_grad(layer, x, g):
    """JAX layer forward on ``x`` and the gradient of ``sum(out * g)``."""
    xt = Tensor(jnp.asarray(x), stop_gradient=False)
    out = layer(xt)
    paddle.sum(out * Tensor(jnp.asarray(g))).backward()
    return _np(out), _np(xt.grad)


def _port_fwd_grad(layer, x, g):
    xt = torch.tensor(x, requires_grad=True)
    out = layer(xt)
    (out * torch.from_numpy(g)).sum().backward()
    return _np(out), _np(xt.grad)


# (JAX class, port class, kwargs)
_QUANTIZERS = {
    "abs_max": (jql.FakeQuantAbsMax, tq.FakeQuantAbsMax, {}),
    "channel_axis0": (jql.FakeQuantChannelWiseAbsMax,
                      tq.FakeQuantChannelWiseAbsMax,
                      dict(channel_num=6, quant_axis=0)),
    "channel_axis1": (jql.FakeQuantChannelWiseAbsMax,
                      tq.FakeQuantChannelWiseAbsMax,
                      dict(channel_num=10, quant_axis=1)),
    "moving_average": (jql.FakeQuantMovingAverageAbsMax,
                       tq.FakeQuantMovingAverageAbsMax, {}),
    "bits4": (jql.FakeQuantAbsMax, tq.FakeQuantAbsMax,
              dict(quant_bits=4)),
}


@pytest.mark.parametrize("kind", sorted(_QUANTIZERS))
def test_fake_quant_forward_and_ste_gradient_match_jax(kind):
    jcls, tcls, kw = _QUANTIZERS[kind]
    jl, tl = jcls(**kw), tcls(device="cpu", **kw)
    jl.train()
    tl.train()
    x, g = _x((6, 10), 0), _x((6, 10), 1, 1.0)
    jo, jg = _jax_fwd_grad(jl, x, g)
    to, tg = _port_fwd_grad(tl, x, g)
    np.testing.assert_allclose(to, jo, **TOL)
    np.testing.assert_allclose(tg, jg, **TOL)
    # the straight-through gradient is the identity
    np.testing.assert_array_equal(tg, g)
    assert not np.allclose(to, x)          # quantization happened
    np.testing.assert_allclose(_np(tl.scale), _np(jl.scale), **TOL)


@pytest.mark.parametrize("kind", ["fake_quant", "observer"])
def test_moving_average_observers_over_training_steps(kind):
    """5 training steps of ``accum``/``state``/``scale`` updates, then eval
    freezes them; the port's buffers follow the JAX package's at 1e-6."""
    if kind == "fake_quant":
        jl = jql.FakeQuantMovingAverageAbsMax(moving_rate=0.9)
        tl = tq.FakeQuantMovingAverageAbsMax(moving_rate=0.9, device="cpu")
    else:
        jl = jql.MovingAverageAbsMaxScale(moving_rate=0.9)
        tl = tq.MovingAverageAbsMaxScale(moving_rate=0.9, device="cpu")
    jl.train()
    tl.train()
    for step in range(5):
        x = _x((4, 8), 10 + step, scale=1.0 + step)
        jo = _np(jl(Tensor(jnp.asarray(x))))
        with torch.no_grad():
            to = _np(tl(torch.from_numpy(x)))
        np.testing.assert_allclose(to, jo, **TOL)
        for b in ("scale", "state", "accum"):
            np.testing.assert_allclose(_np(getattr(tl, b)),
                                       _np(getattr(jl, b)), **TOL)
    if kind == "observer":
        np.testing.assert_array_equal(to, x)          # pass-through
    frozen = _np(tl.scale).copy()
    jl.eval()
    tl.eval()
    x = _x((4, 8), 99, scale=50.0)
    with torch.no_grad():
        to = _np(tl(torch.from_numpy(x)))
    np.testing.assert_allclose(to, _np(jl(Tensor(jnp.asarray(x)))), **TOL)
    np.testing.assert_array_equal(_np(tl.scale), frozen)
    # the observer state is persistent; the abs-max scales are not
    assert set(tl.state_dict()) == {"scale", "state", "accum"}
    assert set(tq.FakeQuantAbsMax(device="cpu").state_dict()) == set()


def _qlinear_pair(wtype, seed=0):
    """A JAX and a port ``QuantizedLinear`` over the same (32, 48)
    weights (weight first, then bias, carried by ``load_jax_state``)."""
    paddle.seed(seed)
    jq = jql.QuantizedLinear(JLinear(32, 48), weight_quantize_type=wtype)
    tq_ = tq.QuantizedLinear(TLinear(32, 48, device="cpu"),
                             weight_quantize_type=wtype)
    arrays = {k: np.asarray(v.numpy()) for k, v in jq.state_dict().items()}
    arrays["bias"] = _x((48,), seed + 7, 0.1)
    jq.bias._set_value(jnp.asarray(arrays["bias"]))
    load_jax_state(tq_, arrays)
    return jq, tq_


@pytest.mark.parametrize("wtype", ["abs_max", "channel_wise_abs_max"])
def test_quantized_linear_matches_jax(wtype):
    jq, tq_ = _qlinear_pair(wtype)
    jq.train()
    tq_.train()
    assert [k for k, _ in tq_.named_parameters()] == ["weight", "bias"]
    for step in range(3):
        x, g = _x((5, 32), 20 + step), _x((5, 48), 30 + step, 1.0)
        jo, jg = _jax_fwd_grad(jq, x, g)
        to, tg = _port_fwd_grad(tq_, x, g)
        np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(tq_.weight.grad), _np(jq.weight.grad),
                               rtol=1e-5, atol=1e-5)
    for name in ("_fake_quant_input.scale", "_fake_quant_input.accum",
                 "_fake_quant_weight.scale"):
        np.testing.assert_allclose(
            _np(tq_.get_buffer(name)),
            _np(dict(jq.named_buffers())[name]), **TOL)
    # the port's state names are the JAX package's
    assert set(state_to_numpy(tq_)) == set(jq.state_dict())


def test_convert_to_weight_only_uses_learned_scales():
    """``tests/test_quant_serving.py``'s QAT export case against the JAX
    package: scale == learned absmax / 127 per channel, the per-tensor
    scalar broadcast over the output channels, and the int8 weights and
    scales bit for bit the JAX package's."""
    jfc, tfc = _qlinear_pair("channel_wise_abs_max", seed=0)
    jhead, thead = _qlinear_pair("abs_max", seed=1)
    x = _x((4, 32), 0, 1.0)
    for j, t in ((jfc, tfc), (jhead, thead)):
        j.train()
        t.train()
        j(Tensor(jnp.asarray(x)))
        with torch.no_grad():
            t(torch.from_numpy(x))
    learned = _np(tfc._fake_quant_weight.scale).copy()
    scalar = _np(thead._fake_quant_weight.scale).copy()
    w = _np(tfc.weight).copy()

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc, self.head = tfc, thead

    net = Net()
    assert tq.convert_to_weight_only(net) == 2
    jw = [jwo.WeightOnlyLinear.from_qat(jfc), jwo.WeightOnlyLinear.from_qat(
        jhead)]
    for lay, ref in zip((net.fc, net.head), jw):
        assert type(lay).__name__ == "WeightOnlyLinear"
        assert lay.weight.dtype == torch.int8
        np.testing.assert_array_equal(_np(lay.weight),
                                      np.asarray(ref.weight._value))
        np.testing.assert_array_equal(
            _np(lay.weight_scale).view(np.uint32),
            np.asarray(ref.weight_scale._value).view(np.uint32))
    np.testing.assert_array_equal(_np(net.fc.weight_scale),
                                  np.float32(learned) / np.float32(127.0))
    assert scalar.shape == (1,)
    assert tuple(net.head.weight_scale.shape) == (48,)
    np.testing.assert_array_equal(_np(net.head.weight_scale),
                                  np.full(48, scalar[0] / np.float32(127.0),
                                          np.float32))
    # the grid of _ste_quant_dequant: round(w / (absmax / 127)) steps
    s = learned[None, :] / np.float32(127.0)
    deq = _np(net.fc.weight).astype(np.float32) * _np(net.fc.weight_scale)
    np.testing.assert_allclose(deq, np.clip(np.round(w / s), -127, 127) * s,
                               atol=1e-6)
    assert net.fc.bias is tfc.bias         # shared, not copied


def test_convert_rejects_per_in_channel_qat_scales():
    q = tq.QuantizedLinear(TLinear(32, 32, device="cpu"),
                           weight_quantize_type="channel_wise_abs_max",
                           weight_quant_axis=0)
    torch.nn.init.normal_(q.weight)
    q(torch.from_numpy(_x((2, 32), 0)))
    with pytest.raises(ValueError, match="weight_quant_axis"):
        tq.WeightOnlyLinear.from_qat(q)


def test_never_run_observer_falls_back_to_measuring():
    q = tq.QuantizedLinear(TLinear(16, 24, device="cpu"),
                           weight_quantize_type="channel_wise_abs_max")
    torch.nn.init.normal_(q.weight)
    lay = tq.WeightOnlyLinear.from_qat(q)
    want_q, want_s = tq.quantize_array(q.weight.detach(), "int8")
    assert torch.equal(lay.weight, want_q)
    assert torch.equal(lay.weight_scale, want_s)


def test_conv_wrappers_raise_and_surface_matches_jax():
    with pytest.raises(NotImplementedError, match="item 11"):
        tq.QuantizedConv2D(None)
    with pytest.raises(NotImplementedError, match="item 11"):
        tq.QuantizedConv2DTranspose(None)
    for name in jql.__all__:
        assert hasattr(tq, name), name
    assert tq.QuantStub is tq.MovingAverageAbsMaxScale
    wrapped = tq.MAOutputScaleLayer(TLinear(4, 4, device="cpu"),
                                    device="cpu")
    torch.nn.init.normal_(wrapped._layer.weight)
    wrapped(torch.ones(2, 4))
    assert float(wrapped._ma_output_scale.scale) > 1e-3
    fq = tq.FakeQuantMAOutputScaleLayer(TLinear(4, 4, device="cpu"),
                                        device="cpu")
    assert tuple(fq(torch.ones(2, 4)).shape) == (2, 4)


def test_functional_layers_match_jax():
    a, b = _x((2, 3), 0), _x((2, 3), 1)
    ja, jb = Tensor(jnp.asarray(a)), Tensor(jnp.asarray(b))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for op in ("add", "subtract", "multiply", "divide"):
        np.testing.assert_array_equal(_np(getattr(TFL, op)()(ta, tb)),
                                      _np(getattr(JFL, op)()(ja, jb)))
    cases = (("reshape", ([3, 2],)), ("transpose", ([1, 0],)),
             ("flatten", ()))
    for op, args in cases:
        np.testing.assert_array_equal(_np(getattr(TFL, op)()(ta, *args)),
                                      _np(getattr(JFL, op)()(ja, *args)))
    np.testing.assert_array_equal(
        _np(TFL.concat()([ta, tb], axis=1)),
        _np(JFL.concat()([ja, jb], axis=1)))
    assert issubclass(TFL.add, TFL.FloatFunctionalLayer)


# ------------------------------------------------------------- QAT GPT
def _wrap(model, qcls, blocks):
    for blk in blocks:
        for part, name in _PROJ:
            parent = getattr(blk, part)
            setattr(parent, name, qcls(
                getattr(parent, name),
                weight_quantize_type="channel_wise_abs_max"))


@pytest.fixture(scope="module")
def qat_pair():
    """A 2-layer QAT GPT in both packages on the same weights and observer
    state, after 3 training-mode forwards on the same batches."""
    paddle.seed(3)
    jm = JGPT(JConfig(**_CFG))
    _wrap(jm, jql.QuantizedLinear, jm.gpt.blocks)
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**_CFG), device="cpu")
    _wrap(tm, tq.QuantizedLinear, tm.gpt.blocks)
    arrays = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    load_jax_state(tm, arrays)
    jm.train()
    tm.train()
    logits = []
    for step in range(3):
        ids = np.random.RandomState(40 + step).randint(
            0, 128, (2, 12)).astype(np.int32)
        jl = _np(jm(Tensor(jnp.asarray(ids))))
        with torch.no_grad():
            tl = _np(tm(torch.from_numpy(ids)))
        logits.append((jl, tl))
    return jm, tm, logits


def test_qat_gpt_forwards_and_observers_match_jax(qat_pair):
    jm, tm, logits = qat_pair
    for jl, tl in logits:
        np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
    jbufs = dict(jm.named_buffers())
    tbufs = dict(tm.named_buffers())
    assert set(tbufs) == set(jbufs) and len(tbufs) == 2 * 4 * 4
    for name, jb in jbufs.items():
        np.testing.assert_allclose(_np(tbufs[name]), _np(jb), **TOL)


def test_qat_gpt_converted_and_served_matches_jax_engine(qat_pair,
                                                         tmp_path):
    """Convert in both packages (the same int8 weights and scales, bit for
    bit), save the port's, reload it, and serve it on the port's dense and
    paged engines: token-exact against the JAX engine on the JAX-converted
    model."""
    jm, tm, _ = qat_pair
    jm.eval()
    tm.eval()
    assert jwo.convert_to_weight_only(jm) == 8
    assert tq.convert_to_weight_only(tm) == 8
    for jb, tb in zip(jm.gpt.blocks, tm.gpt.blocks):
        for part, name in _PROJ:
            jl = getattr(getattr(jb, part), name)
            tl = getattr(getattr(tb, part), name)
            np.testing.assert_array_equal(_np(tl.weight),
                                          np.asarray(jl.weight._value))
            np.testing.assert_array_equal(
                _np(tl.weight_scale).view(np.uint32),
                np.asarray(jl.weight_scale._value).view(np.uint32))
    save_for_serving(tm, tmp_path / "qat")
    served = load_for_serving(tmp_path / "qat", device="cpu")
    rs = np.random.RandomState(5)
    prompts = [rs.randint(0, 128, (n,)).astype(np.int32)
               for n in (6, 9, 5, 11)]
    jeng = JEngine(jm, auto_run=False, max_slots=2, max_len=64, chunk=4)
    jreqs = [jeng.submit(p, 8) for p in prompts]
    jeng.run_until_idle()
    want = [r.result() for r in jreqs]
    jeng.shutdown(timeout=5)
    for kw in ({}, dict(cache_mode="paged", page_size=8)):
        eng = ServingEngine(served, auto_run=False, max_slots=2, max_len=64,
                            chunk=4, **kw)
        reqs = [eng.submit(p, 8) for p in prompts]
        eng.run_until_idle()
        for r, w in zip(reqs, want):
            np.testing.assert_array_equal(r.result(), w)
        eng.shutdown(timeout=5)
