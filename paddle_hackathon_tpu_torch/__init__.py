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
(``incubate/nn/kernels/quant_matmul.py`` + ``csrc/quant_matmul.cu``).
"""

from .core.device import resolve_device
from .core.random import seed

__all__ = ["resolve_device", "seed"]
