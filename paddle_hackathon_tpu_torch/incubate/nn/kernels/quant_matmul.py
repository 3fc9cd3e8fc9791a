"""Weight-only quantized matrix product: the plain PyTorch version and the
dispatch to the hand-written Hopper kernel (K4).

Port of the JAX package's ``incubate/nn/kernels/quant_matmul.py``.  Each
serving projection stores its weight as int8 (or fp8-e4m3) ``(K, N)``
with one f32 scale per output column; activations stay bf16.  Because the
scale is constant over the contraction, ``x @ (w_q * s) == (x @ w_q) * s``:
dequantization commutes out of the product.

- :func:`quant_matmul_ref` is the plain version: widen ``w_q`` to f32, the
  product in f32, times the scale, cast to x's dtype.  CPU tensors take
  it.  (A bf16 ``torch.matmul`` would round before the scale: it is not
  this function.)
- :func:`quant_matmul_kernel` launches ``csrc/quant_matmul.cu`` on a CUDA
  tensor: the same f32 arithmetic, one summation order per output element
  whatever M is.
- :func:`quant_matmul` flattens the leading dims, dispatches, and adds the
  bias in the activation dtype outside the kernel.  Geometry the kernel
  does not take (K or N not a multiple of 128, or a float weight) goes to
  the plain version on every device, as the JAX dispatch chooses by
  shape; a CPU tensor takes the plain version; a CUDA tensor with
  supported geometry launches the kernel or raises.  There is no fallback
  from a failed build or launch to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

_LANES = 128
_X_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_W_CODES = {torch.int8: 0, torch.float8_e4m3fn: 1}

# kernel launches since the last reset (the smoke run reads it to prove
# the serving path went through the kernel)
launches = 0


def supported(k: int, n: int, w_dtype) -> bool:
    """Whether the kernel takes this geometry (else the plain version
    runs): K and N multiples of 128 and an int8 or fp8-e4m3 weight."""
    return k % _LANES == 0 and n % _LANES == 0 and w_dtype in _W_CODES


def quant_matmul_ref(x, w_q, scale):
    """``(x @ widen(w_q)) * scale`` in f32, cast to ``x.dtype``.  ``x``
    (..., K), ``w_q`` (K, N) int8/fp8, ``scale`` (N,) f32."""
    acc = x.float() @ w_q.float()
    return (acc * scale.float()).to(x.dtype)


def check_kernel_args(x2d, w_q, scale) -> None:
    """Raise ``ValueError`` unless the kernel takes these arguments:
    shapes, dtypes, geometry, devices, contiguity and 16-byte
    alignment."""
    if x2d.dim() != 2 or w_q.dim() != 2 or scale.dim() != 1:
        raise ValueError("x must be (M, K), w_q (K, N) and scale (N,)")
    m, k = x2d.shape
    if w_q.shape[0] != k or scale.shape[0] != w_q.shape[1]:
        raise ValueError(f"shapes x {tuple(x2d.shape)}, w_q "
                         f"{tuple(w_q.shape)}, scale {tuple(scale.shape)} "
                         f"do not agree")
    n = w_q.shape[1]
    if not supported(k, n, w_q.dtype):
        raise ValueError(
            f"quant_matmul_kernel requires lane-aligned K/N (multiples of "
            f"{_LANES}) and an int8/fp8 weight; got K={k}, N={n}, "
            f"dtype={w_q.dtype}")
    if x2d.dtype not in _X_CODES:
        raise ValueError(f"unsupported activation dtype {x2d.dtype}")
    if scale.dtype != torch.float32:
        raise ValueError(f"scale must be float32, got {scale.dtype}")
    for name, t in (("x", x2d), ("w_q", w_q), ("scale", scale)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != x2d.device:
            raise ValueError(f"{name} is on {t.device}, x on {x2d.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


_launch_fn = None


def _lib():
    """The kernel's C entry point, built and bound at first use."""
    global _launch_fn
    if _launch_fn is None:
        from ._build import load
        fn = load("quant_matmul").quant_matmul_launch
        # c_void_p for every pointer and the stream, or ctypes passes them
        # as 32-bit ints and cuts them
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ci, ci, vp, vp, vp, vp, ci, ci, ci, vp]
        fn.restype = ctypes.c_int
        _launch_fn = fn
    return _launch_fn


def quant_matmul_kernel(x2d, w_q, scale):
    """Launch the Hopper kernel on PyTorch's current stream; ``x2d`` is
    (M, K), returns (M, N) in x's dtype.  Raises on arguments the kernel
    does not take or a launch the device refuses."""
    global launches
    if x2d.device.type != "cuda":
        raise ValueError(f"the quant_matmul kernel runs on CUDA tensors, "
                         f"got {x2d.device}")
    check_kernel_args(x2d, w_q, scale)
    m, k = x2d.shape
    n = w_q.shape[1]
    out = torch.empty(m, n, dtype=x2d.dtype, device=x2d.device)
    if m == 0:
        return out
    fn = _launch_fn or _lib()
    dev = x2d.device.index
    with torch.cuda.device(dev):
        # the stream's handle as an int, without a torch.cuda.Stream
        # object per call (the serving path makes 48 calls a forward)
        err = fn(_X_CODES[x2d.dtype], _W_CODES[w_q.dtype], x2d.data_ptr(),
                 w_q.data_ptr(), scale.data_ptr(), out.data_ptr(), m, k, n,
                 torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"quant_matmul kernel launch failed: "
                           f"CUDA error {err}")
    launches += 1
    return out


def quant_matmul(x, w_q, scale, bias=None):
    """``x`` (..., K) in bf16/f32 times the quantized ``w_q`` (K, N) with
    per-column ``scale`` (N,), plus ``bias`` (N,) in x's dtype.  Dispatch:
    unsupported geometry or a CPU tensor -> the plain version; a CUDA
    tensor -> the kernel (or raise)."""
    k, n = w_q.shape
    lead = x.shape[:-1]
    x2d = x.reshape(-1, k)
    if x.device.type == "cpu" or not supported(k, n, w_q.dtype):
        out = quant_matmul_ref(x2d, w_q, scale)
    elif x.device.type == "cuda":
        out = quant_matmul_kernel(x2d.contiguous(), w_q, scale)
    else:
        raise ValueError(f"quant_matmul: unsupported device {x.device}")
    out = out.reshape(*lead, n)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out
