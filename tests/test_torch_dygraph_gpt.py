"""The slice as a whole: a 2-layer GPT (hidden 64, 2 heads, vocab 128,
s = 32, dropout 0) trained 3 Adam steps through the Paddle dygraph idiom
in both packages, on the JAX package's weights (``load_jax_state``)::

    ids = paddle.to_tensor(batch); logits = model(ids)
    loss = F.cross_entropy(logits, labels); loss.backward()
    opt.step(); opt.clear_grad()

Losses agree at f32 rtol 1e-5 (atol 1e-6), final weights at rtol 1e-5
and atol 1e-5 (as the updated parameters of ``test_torch_train.py``:
Adam divides each step by the gradient's own scale, so the two
libraries' rounding of a small gradient entry moves a weight by up to a
few 1e-6; measured 1.6e-6 on one entry of 12,288).  Adam's
epsilon is 1e-6 here, as in ``test_torch_train.py``: at the default 1e-8
a gradient entry that is 0 up to rounding (the key bias's, whose softmax
ignores it) moves its parameter by about ``lr * sign(g)``, so a 1e-9
difference in g would become a 1e-3 difference in the weight.  The same
model's ``functional_call`` step (``make_functional_train_step`` with
Adam and ``ClipGradByGlobalNorm``) equals ``make_sharded_train_step``'s,
and the top-level surface ``import paddle_hackathon_tpu_torch as paddle``
exposes every name of the JAX package's ``__init__`` this slice ports,
importing without a card.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_hackathon_tpu as jp
import paddle_hackathon_tpu_torch as tp
from paddle_hackathon_tpu.models.gpt import GPTConfig as JConfig
from paddle_hackathon_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_hackathon_tpu.nn import functional as jF
from paddle_hackathon_tpu_torch.models import gpt as tgpt
from paddle_hackathon_tpu_torch.nn import functional as tF
from paddle_hackathon_tpu_torch.nn.layer import functional_call
from paddle_hackathon_tpu_torch.parallel import (make_functional_train_step,
                                                 make_sharded_train_step)
from paddle_hackathon_tpu_torch.utils import load_jax_state

RTOL, ATOL = 1e-5, 1e-6
_CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=2,
            max_position_embeddings=64, hidden_dropout_prob=0.0,
            attention_dropout_prob=0.0, use_flash_attention=False)
_B, _S, _STEPS = 4, 32, 3


@pytest.fixture(scope="module")
def arrays():
    jp.seed(5)
    jm = JGPT(JConfig(**_CFG))
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _port_model(arrays):
    return load_jax_state(tgpt.GPTForCausalLM(tgpt.GPTConfig(**_CFG),
                                              device="cpu"), arrays)


def _batches():
    rng = np.random.RandomState(7)
    return [(rng.randint(0, 128, (_B, _S)).astype(np.int32),
             rng.randint(0, 128, (_B, _S)).astype(np.int32))
            for _ in range(_STEPS)]


def _train(p, F, model, opt):
    losses = []
    for batch, labels in _batches():
        ids = p.to_tensor(batch)
        logits = model(ids)
        loss = F.cross_entropy(logits, p.to_tensor(labels))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses


def test_dygraph_training_matches_jax(arrays):
    tp.set_device("cpu")
    jm = JGPT(JConfig(**_CFG))
    jm.set_state_dict(arrays)
    tm = _port_model(arrays)
    jopt = jp.optimizer.Adam(learning_rate=1e-3, epsilon=1e-6,
                             parameters=jm.parameters(),
                             grad_clip=jp.nn.ClipGradByGlobalNorm(1.0))
    topt = tp.optimizer.Adam(learning_rate=1e-3, epsilon=1e-6,
                             parameters=tm.parameters(),
                             grad_clip=tp.nn.ClipGradByGlobalNorm(1.0))
    jl = _train(jp, jF, jm, jopt)
    tl = _train(tp, tF, tm, topt)
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    tsd = tm.state_dict()
    assert not np.allclose(tsd["gpt.wte.weight"].numpy(),
                           arrays["gpt.wte.weight"])
    for name, v in jm.state_dict().items():
        np.testing.assert_allclose(tsd[name].numpy(), np.asarray(v._value),
                                   rtol=RTOL, atol=1e-5, err_msg=name)
    # the path in between: Tensors in, a Tensor loss, torch grads on the
    # parameters, cleared by the optimizer
    logits = tm(tp.to_tensor(_batches()[0][0]))
    assert isinstance(logits, tp.Tensor) and logits.shape == [_B, _S, 128]
    assert all(p.grad is None for p in tm.parameters())


def test_functional_call_step_equals_sharded_step(arrays):
    """``make_functional_train_step`` over ``functional_call`` with Adam
    (beta2 0.95, the sharded step's default) and the global-norm clip,
    against ``make_sharded_train_step`` from the same weights and
    batches."""
    ma, mb = _port_model(arrays), _port_model(arrays)
    sstep, state = make_sharded_train_step(ma, learning_rate=1e-3,
                                           grad_clip_norm=1.0)
    named = list(mb.named_parameters())
    order = [n for n, _ in named]
    opt = tp.optimizer.Adam(learning_rate=1e-3, beta2=0.95,
                            parameters=named,
                            grad_clip=tp.nn.ClipGradByGlobalNorm(1.0))

    def grads_of(params, xs, ys, step):
        ps = {k: v.detach().requires_grad_() for k, v in params.items()}
        logits = functional_call(mb, ps, (xs,))
        loss = tF.cross_entropy(logits, ys)
        return loss.detach(), dict(zip(ps, torch.autograd.grad(
            loss, list(ps.values()))))

    fstep = make_functional_train_step(opt, [p for _, p in named], order,
                                       grads_of)
    params = {n: p.detach() for n, p in named}
    states, t = opt.functional_state([p for _, p in named]), 0
    fl, sl = [], []
    for ids, labels in _batches():
        state, loss = sstep(state, ids, labels)
        sl.append(float(loss))
        params, states, t, loss = fstep(params, states, t, 1e-3,
                                        (torch.from_numpy(ids).long(),
                                         torch.from_numpy(labels).long()))
        fl.append(float(loss))
    np.testing.assert_allclose(fl, sl, rtol=RTOL, atol=ATOL)
    for name, p in ma.named_parameters():
        np.testing.assert_allclose(params[name].numpy(), p.detach().numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


# -- the top-level surface ---------------------------------------------------
_PORTED = [
    "Tensor", "to_tensor", "grad", "no_grad", "enable_grad",
    "set_grad_enabled", "is_grad_enabled", "set_device", "get_device",
    "device_count", "current_place", "synchronize", "Place",
    "get_cudnn_version", "is_compiled_with_cuda", "is_compiled_with_tpu",
    "is_compiled_with_rocm", "is_compiled_with_xpu", "is_compiled_with_npu",
    "is_compiled_with_mlu", "is_compiled_with_ipu", "is_compiled_with_cinn",
    "bool", "bool_", "uint8", "int8", "int16", "int32", "int64", "float16",
    "bfloat16", "float32", "float64", "complex64", "complex128",
    "get_default_dtype", "set_default_dtype", "seed", "get_rng_state",
    "set_rng_state", "set_flags", "get_flags", "Layer", "Parameter",
    "create_parameter", "ParamAttr", "ops", "tensor", "autograd", "nn"]
_NN = ["Layer", "Sequential", "LayerList", "ParameterList", "LayerDict",
       "Identity", "ParamAttr", "Parameter", "create_parameter",
       "initializer", "functional_call"]


def test_top_level_surface():
    for name in _PORTED:
        assert hasattr(jp, name), name
        assert hasattr(tp, name), name
    for name in jp.ops.OP_TABLE:
        assert hasattr(tp, name), name
    for name in _NN:
        assert hasattr(jp.nn, name) and hasattr(tp.nn, name), name
    assert tp.autograd.PyLayer and tp.autograd.PyLayerContext
    assert tp.tensor.math is tp.ops.math
    for name in ("Constant", "Assign", "Normal", "TruncatedNormal",
                 "Uniform", "XavierNormal", "XavierUniform",
                 "KaimingNormal", "KaimingUniform", "Orthogonal", "Dirac"):
        assert hasattr(tp.nn.initializer, name), name


def test_imports_without_a_card():
    """The package imports with no CUDA device visible and without JAX
    (a module that imports it fails the import)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys; sys.modules['jax'] = None; "
            "import paddle_hackathon_tpu_torch as paddle; "
            "print(paddle.get_device(), len(paddle.ops.OP_TABLE))")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["gpu:0", "296"]
