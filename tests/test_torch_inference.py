"""The port's deployment front end (``paddle_hackathon_tpu_torch.
inference``: ``config.py``, ``predictor.py``) against the JAX package's,
on the CPU.

- ``Config``'s knobs, the pass builder and ``summary()`` key for key (the
  device row reads ``cuda`` where the JAX package reads ``tpu``).
- ``create_predictor`` on ``save_for_serving`` artifacts saved by either
  package (f32 and int8, a 2-layer GPT at hidden 64): zero-copy and
  convenience runs, ``clone`` and ``PredictorPool`` (``tests/
  test_inference.py``'s cases and ``tests/test_quant_serving.py``'s
  quantized-directory case), logits within 1e-5 of the JAX
  ``Predictor``'s on the same artifact.
- The JAX package's StableHLO artifacts (``jit``, ``static``) raise and
  cite ROADMAP Queue 1 item 13; a default ``Config`` raises where there is
  no card (no CPU fallback).
"""

import numpy as np
import pytest
import torch

import paddle_hackathon_tpu as paddle
from paddle_hackathon_tpu import inference as jinf
from paddle_hackathon_tpu import nn as jnn
from paddle_hackathon_tpu.inference import serving as jserving
from paddle_hackathon_tpu.jit import InputSpec
from paddle_hackathon_tpu.models.gpt import GPTConfig as JConfig
from paddle_hackathon_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_hackathon_tpu_torch import inference as tinf
from paddle_hackathon_tpu_torch.models import gpt as tgpt
from paddle_hackathon_tpu_torch.utils import load_jax_state

_CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            max_position_embeddings=128, hidden_dropout_prob=0.0,
            attention_dropout_prob=0.0, use_flash_attention=False)
TOL = dict(rtol=1e-5, atol=1e-5)


def _summary(cfg):
    return dict(ln.split(None, 1) if len(ln.split(None, 1)) == 2
                else (ln.strip(), "") for ln in cfg.summary().splitlines())


def _cpu(cfg):
    cfg.disable_gpu()
    return cfg


def _ids(shape=(2, 8), seed=0):
    return np.random.RandomState(seed).randint(0, 128, shape).astype(
        np.int32)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """f32 and int8 serving artifacts saved by the JAX package and by the
    port, from one set of weights."""
    tmp = tmp_path_factory.mktemp("artifacts")
    paddle.seed(3)
    jm = JGPT(JConfig(**_CFG))
    jm.eval()
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**_CFG), device="cpu")
    load_jax_state(tm, {k: np.asarray(v.numpy())
                        for k, v in jm.state_dict().items()})
    out = {}
    for pkg, save, m in (("jax", jserving.save_for_serving, jm),
                         ("port", tinf.save_for_serving, tm)):
        for quant in (None, "int8"):
            d = str(tmp / f"{pkg}_{quant or 'f32'}")
            save(m, d, quant=quant)
            out[(pkg, quant or "f32")] = d
    return out


def _jax_logits(d, ids):
    cfg = jinf.Config(d)
    cfg.disable_gpu()
    (out,) = jinf.create_predictor(cfg).run([ids])
    return np.asarray(out, np.float32)


def test_config_surface_and_summary_key_for_key():
    for mod in (jinf, tinf):
        cfg = mod.Config("m.pdmodel", "m.pdiparams")
        cfg.enable_use_gpu(100, 0)
        assert cfg.use_gpu() and cfg.gpu_device_id() == 0
        cfg.switch_ir_optim(False)
        assert not cfg.ir_optim()
        cfg.set_cpu_math_library_num_threads(4)
        assert cfg.cpu_math_library_num_threads() == 4
        cfg.enable_memory_optim()
        assert cfg.memory_optim_enabled()
        cfg.set_optim_cache_dir("/cache")
        cfg.disable_glog_info()
        assert cfg.glog_info_disabled()
        pb = cfg.pass_builder()
        pb.delete_pass("persistent_cache_pass")
        pb.append_pass("extra_pass")
        pb.insert_pass(0, "first_pass")
        assert pb.all_passes() == ["first_pass", "donate_feed_buffers_pass",
                                   "resident_params_pass", "extra_pass"]
        cfg.enable_tpu(1)
        assert cfg.use_gpu() and cfg.gpu_device_id() == 1
        cfg.disable_gpu()
        assert not cfg.use_gpu()
    assert tinf.AnalysisConfig is tinf.Config
    j, t = jinf.Config("m", "p"), tinf.Config("m", "p")
    js, ts = _summary(j), _summary(t)
    assert list(ts) == list(js)
    assert {k: v for k, v in ts.items() if k != "device"} == \
        {k: v for k, v in js.items() if k != "device"}
    assert js["device"] == "tpu:0" and ts["device"] == "cuda:0"
    j.disable_gpu()
    t.disable_gpu()
    assert _summary(t) == _summary(j)


def test_pass_builder_register_and_apply():
    seen = []
    tinf.PassBuilder.register("probe_pass")(lambda ctx: seen.append(ctx))
    pb = tinf.PassBuilder(["probe_pass", "unknown_pass"])
    pb.apply("ctx")
    assert seen == ["ctx"]


@pytest.mark.parametrize("pkg", ["jax", "port"])
@pytest.mark.parametrize("quant", ["f32", "int8"])
def test_predictor_zero_copy_and_convenience_match_jax(artifacts, pkg,
                                                        quant):
    d = artifacts[(pkg, quant)]
    ids = _ids()
    want = _jax_logits(d, ids)
    cfg = _cpu(tinf.Config(d))
    pred = tinf.create_predictor(cfg)
    assert pred.get_input_names() == ["input_ids"]
    h = pred.get_input_handle("input_ids")
    h.reshape([2, 8])
    h.copy_from_cpu(ids)
    assert pred.run() is True
    (name,) = pred.get_output_names()
    out = pred.get_output_handle(name)
    assert out.shape() == [2, 8, 128] and out.type() == torch.float32
    np.testing.assert_allclose(out.copy_to_cpu(), want, **TOL)
    # convenience run; then the same handles again (no memory optim: the
    # feeds stay bound)
    (logits,) = pred.run([ids])
    np.testing.assert_allclose(logits, want, **TOL)
    assert pred.run() is True
    # the quantized artifact serves through WeightOnlyLinear (K4's plain
    # version here), equal to the loaded model's own forward
    if quant == "int8":
        blk = pred._model.gpt.blocks[0]
        assert type(blk.attn.qkv_proj).__name__ == "WeightOnlyLinear"
        with torch.no_grad():
            own = pred._model(torch.from_numpy(ids)).numpy()
        np.testing.assert_array_equal(logits, own)


def test_predictor_clone_and_pool_share_the_model(artifacts):
    d = artifacts[("port", "f32")]
    ids, ids2 = _ids(), _ids((3, 5), 1)
    pred = tinf.create_predictor(_cpu(tinf.Config(d)))
    (a,) = pred.run([ids])
    c = pred.clone()
    assert c._model is pred._model              # no second weight copy
    (b,) = c.run([ids2])
    assert b.shape == (3, 5, 128)
    # independent handles: the clone's bind left the original's alone
    assert pred.get_input_handle("input_ids").shape() == [2, 8]
    np.testing.assert_allclose(b, _jax_logits(d, ids2), **TOL)
    pool = tinf.PredictorPool(_cpu(tinf.Config(d)), size=3)
    models = {id(pool.retrieve(i)._model) for i in range(3)}
    assert len(models) == 1
    for i in range(3):
        (out,) = pool.retrieve(i).run([ids])
        np.testing.assert_allclose(out, a, rtol=0, atol=0)
    pred.clear_intermediate_tensor()
    with pytest.raises(RuntimeError, match="run"):
        pred.get_output_handle("fetch_0").copy_to_cpu()


def test_handles_memory_optim_and_errors(artifacts):
    d = artifacts[("port", "f32")]
    cfg = _cpu(tinf.Config())
    cfg.set_model(d)
    cfg.enable_memory_optim()
    pred = tinf.create_predictor(cfg)
    with pytest.raises(RuntimeError, match="not set"):
        pred.run()
    ids = _ids()
    pred.run([ids])
    # memory optim released the feeds after the convenience run
    assert pred.get_input_handle("input_ids").shape() == []
    with pytest.raises(RuntimeError, match="not set"):
        pred.run()
    h = pred.get_input_handle("input_ids")
    h.reshape([1, 4])
    with pytest.raises(ValueError, match="reshape"):
        h.copy_from_cpu(ids)
    h.share_external_data(torch.from_numpy(ids[:1, :4]))
    assert pred.run() is True
    assert pred.get_output_handle("fetch_0").shape() == [1, 4, 128]
    with pytest.raises(TypeError):
        h.share_external_data(ids)
    with pytest.raises(ValueError, match="Config has no model"):
        tinf.create_predictor(_cpu(tinf.Config()))
    with pytest.raises(FileNotFoundError):
        tinf.create_predictor(_cpu(tinf.Config(d + ".missing")))
    assert tinf.get_version() == jinf.get_version()


def test_stablehlo_artifacts_raise_and_cite_item_13(tmp_path):
    class Net(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = jnn.Linear(8, 4)

        def forward(self, x):
            return self.fc(x)

    paddle.seed(0)
    net = Net()
    net.eval()
    prefix = str(tmp_path / "net")
    paddle.jit.save(net, prefix, input_spec=[InputSpec([-1, 8], "float32")])
    # the JAX predictor serves it; the port refuses with the ROADMAP item
    cfg = jinf.Config(prefix + ".pdmodel")
    cfg.disable_gpu()
    jinf.create_predictor(cfg)
    for path in (prefix + ".pdmodel", prefix):
        with pytest.raises(NotImplementedError, match="item 13"):
            tinf.create_predictor(_cpu(tinf.Config(path)))
    static = tmp_path / "smodel.pdmodel"
    static.write_bytes(b"not a zip: a raw StableHLO program")
    with pytest.raises(NotImplementedError, match="item 13"):
        tinf.create_predictor(_cpu(tinf.Config(str(tmp_path / "smodel"))))


def test_default_config_raises_without_a_card(artifacts, monkeypatch):
    """A default ``Config`` asks for the card: with none it raises, and
    never falls back to the CPU (the JAX package's fallback at
    ``predictor.py:146-150`` is not carried over)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = artifacts[("port", "f32")]
    for cfg in (tinf.Config(d), tinf.AnalysisConfig(d)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tinf.create_predictor(cfg)
    cfg = tinf.Config(d)
    cfg.enable_tpu()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tinf.create_predictor(cfg)
