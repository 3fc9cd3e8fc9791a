"""PyTorch/CUDA port of ``paddle_hackathon_tpu``.

The package mirrors the JAX package's module paths one to one, so each
port module has an obvious counterpart there.  It imports ``torch`` and
numpy, never ``jax`` and nothing of the JAX package.  Entry points place
their work on the CUDA device unless the caller asks for ``"cpu"``; a
kernel wrapper runs its plain PyTorch version only for tensors that lie
on the CPU.

Ported so far: the paged GPT serving path (``models/gpt.py``,
``inference/serving.py``) and its paged-attention kernel
(``incubate/nn/kernels/paged_attention.py`` + ``csrc/paged_attention.cu``);
the one-device GPT training path (``parallel/api.py``
``make_sharded_train_step`` and ``make_functional_train_step``; the
optimizers, LR schedulers, weight decay and clips of ``optimizer/``,
``nn/clip.py`` and ``regularizer.py``; the chunked loss of
``nn/functional/loss.py``) and its packed flash-attention kernels
(``incubate/nn/kernels/flash_attention_packed.py`` +
``csrc/flash_attention_packed.cu``); weight-only int8/fp8 serving from
an artifact (``inference/serving.py`` ``save_for_serving``/
``load_for_serving``, ``nn/quant/``) and its dequant-GEMM kernel
(``incubate/nn/kernels/quant_matmul.py`` + ``csrc/quant_matmul.cu``);
the deployment surface over the engine: ``inference/config.py`` and
``predictor.py`` (``create_predictor``), the QAT layers of ``nn/quant/``
with ``convert_to_weight_only``, the serving fleet ``inference/fleet.py``,
``profiler/cross_stack.py``, and the C ABI of ``native/serving.cc``.

The Paddle dygraph surface (``import paddle_hackathon_tpu_torch as
paddle``): ``Tensor`` and ``to_tensor`` (``core/tensor.py``) over torch
autograd (``core/autograd.py``: the grad-mode switches, ``grad``), the
places (``set_device("gpu" | "cpu")``; the default place is the card),
the dtypes, ``seed`` / ``get_rng_state`` / ``set_rng_state``,
``set_flags`` / ``get_flags``, the op table (``ops/``, ``tensor/``),
``autograd.PyLayer``, and ``nn.Layer`` with ``Parameter``, ``ParamAttr``,
the initializers and the containers (``nn/``).

``Model.fit`` and the input pipeline: ``hapi`` (``Model``, the K-step
trainer of ``hapi/compiled.py``, the callbacks, ``summary`` and
``flops``), ``io`` (``Dataset``, the samplers, ``DataLoader`` over the
native staging ring of ``core/native.py`` + ``native/runtime.cc``,
``device_prefetch``), ``metric``, ``framework`` (``save`` / ``load``),
``cost_model``'s FLOPs and peak, and the loss and activation layers and
functionals of ``nn/``.
"""


# the JAX package's version: the port serves the same artifacts and API
__version__ = "0.1.0"

from .core.autograd import (enable_grad, grad, is_grad_enabled,  # noqa: E402
                            no_grad, set_grad_enabled)
from .core.device import (Place, current_place, device_count,  # noqa: E402
                          get_cudnn_version, get_device,
                          is_compiled_with_cinn, is_compiled_with_cuda,
                          is_compiled_with_ipu, is_compiled_with_mlu,
                          is_compiled_with_npu, is_compiled_with_rocm,
                          is_compiled_with_tpu, is_compiled_with_xpu,
                          resolve_device, set_device, synchronize)
from .core.dtype import (bfloat16, bool_, complex64, complex128,  # noqa: E402
                         float16, float32, float64, get_default_dtype, int8,
                         int16, int32, int64, set_default_dtype, uint8)
from .core.flags import get_flags, set_flags  # noqa: E402
from .core.random import get_rng_state, seed, set_rng_state  # noqa: E402
from .core.tensor import Tensor, to_tensor  # noqa: E402

from . import ops  # noqa: E402
from .ops import *  # noqa: E402,F401,F403 -- the paddle.* op surface
from . import autograd, nn, optimizer, tensor  # noqa: E402
from . import (callbacks, cost_model, framework, hapi, io,  # noqa: E402
               metric)
from .framework.io import load, save  # noqa: E402
from .hapi import Model  # noqa: E402
from .hapi.summary import flops, summary  # noqa: E402
from .nn.layer import Layer  # noqa: E402
from .nn.parameter import ParamAttr, Parameter, create_parameter  # noqa: E402

bool = bool_  # noqa: A001 -- paddle.bool

__all__ = ["resolve_device", "seed", "Tensor", "to_tensor", "grad",
           "no_grad", "enable_grad", "set_grad_enabled", "is_grad_enabled",
           "set_device", "get_device", "device_count", "Layer", "ParamAttr",
           "Parameter", "create_parameter", "set_flags", "get_flags",
           "get_rng_state", "set_rng_state", "Model", "save", "load",
           "summary", "flops"]
