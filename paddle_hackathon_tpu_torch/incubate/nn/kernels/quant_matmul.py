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
  tensor: bf16 / f16 activations on the tensor cores (wgmma on weight
  chunks widened in shared memory), f32 activations on the CUDA cores
  (f32 FMAs, in the same chunks and schedules).
  :func:`quant_plan` is its schedule, a pure function of the shapes: the
  chunks of K whose partials are summed in order (their rows depend on K
  alone, so one summation order per output element whatever M is), and
  whether a tile's chunks are spread over blocks and merged in order by
  the last (the split) or walked by one block (the walk).
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
from typing import NamedTuple

import torch

_LANES = 128
_X_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_W_CODES = {torch.int8: 0, torch.float8_e4m3fn: 1}
# the tensor-core kernel's tile (csrc/quant_matmul.cu kBM, kBN, kKC): rows
# of x, output columns, K rows of a chunk
TILE_M, TILE_N, CHUNK_ROWS = 64, 128, 128
_F32_TILE_M, _F32_TILE_N = 8, 64          # the CUDA-core kernel's tile
_SMS = 132                                # the H100's SMs
_FILL_BLOCKS = 2 * _SMS                   # the split's target block count
# the f32 split's target warps: 4 a decode block (one 8-row tile), 1 a
# prefill block; the walk where the tiles fill half of them
_F32_FILL_WARPS = 16 * _SMS
_SPLIT_BYTES = 25 * 2 ** 20               # its partials: one tile of x,
_WIDE_SPLIT_BYTES = 40 * 2 ** 20          # and more (the L2 holds 50 MB)
_GRID_YZ = 65535

# kernel launches since the last reset (the smoke run reads it to prove
# the serving path went through the kernel), and those of the f32 route
launches = 0
f32_launches = 0


class QuantPlan(NamedTuple):
    """A launch's schedule.  ``route``: ``"tc"`` (bf16/f16 activations,
    wgmma) or ``"f32"`` (CUDA cores).  The sum of an output runs over
    ``chunks`` chunks of ``chunk_rows`` K rows, added in the order
    ``order``; a grid of ``m_tiles`` x ``n_tiles`` tiles, each tile's chunks
    walked ``chunks_per_block`` at a time by ``splits`` blocks (``split``:
    more than one, partials merged by the last block)."""
    route: str
    chunk_rows: int
    chunks: int
    m_tiles: int
    n_tiles: int
    chunks_per_block: int
    splits: int

    @property
    def order(self):
        return tuple(range(self.chunks))

    @property
    def split(self) -> bool:
        return self.splits > 1


def quant_plan(m: int, k: int, n: int, x_dtype) -> QuantPlan:
    """The kernel's schedule for an (m, k) x (k, n) product.  The chunks
    and their order depend on K alone; M and N only choose how the tiles
    and chunks are spread over blocks.  bf16/f16: with one 64-row tile of
    x (M <= 64), tiles that cannot fill the card and partials within half
    the L2, each tile's chunks are spread over blocks, about two blocks
    per SM (the split, decode's schedule); with more rows, tiles that fill
    under a quarter of the SMs and partials within 40 MB, every chunk is
    its own block (the split: fc_out at M = 256 walks 24 chunks in 24
    blocks otherwise); else every block walks all of its tile's chunks
    (the walk).  f32: tiles of 8 rows by 64 columns (decode, M <= 8: a
    block of four warps a tile; else one warp); the split where the tiles
    give under half of ``_F32_FILL_WARPS`` warps (decode, and prefill with
    few tiles), each tile's chunks spread over blocks toward that many
    warps, with partials (f32) within 25 MB at decode and 40 MB past it;
    else the walk."""
    chunks = k // CHUNK_ROWS
    if x_dtype == torch.float32:
        m_tiles, n_tiles = -(-m // _F32_TILE_M), n // _F32_TILE_N
        warps = 4 if m <= _F32_TILE_M else 1      # a block's
        tiles = m_tiles * n_tiles
        limit = _SPLIT_BYTES if m <= _F32_TILE_M else _WIDE_SPLIT_BYTES
        per_block = chunks
        if 2 * tiles * warps < _F32_FILL_WARPS and chunks * m * n * 4 <= limit:
            per_block = min(chunks, -(-chunks * tiles * warps
                                      // _F32_FILL_WARPS))
        return QuantPlan("f32", CHUNK_ROWS, chunks, m_tiles, n_tiles,
                         per_block, -(-chunks // per_block))
    m_tiles, n_tiles = -(-m // TILE_M), n // TILE_N
    part_bytes = chunks * m * n * 8
    per_block = chunks
    if m_tiles == 1:
        if n_tiles < _SMS and part_bytes <= _SPLIT_BYTES:
            per_block = min(chunks, -(-chunks * n_tiles // _FILL_BLOCKS))
    elif 4 * m_tiles * n_tiles <= _SMS and part_bytes <= _WIDE_SPLIT_BYTES:
        per_block = 1
    return QuantPlan("tc", CHUNK_ROWS, chunks, m_tiles, n_tiles, per_block,
                     -(-chunks // per_block))


def supported(k: int, n: int, w_dtype) -> bool:
    """Whether the kernel takes this geometry (else the plain version
    runs): K and N multiples of 128 and an int8 or fp8-e4m3 weight."""
    return k % _LANES == 0 and n % _LANES == 0 and w_dtype in _W_CODES


def quant_matmul_ref(x, w_q, scale):
    """``(x @ widen(w_q)) * scale`` in f32, cast to ``x.dtype``.  ``x``
    (..., K), ``w_q`` (K, N) int8/fp8, ``scale`` (N,) f32."""
    acc = x.float() @ w_q.float()
    return (acc * scale.float()).to(x.dtype)


def check_geometry(m: int, k: int, n: int, x_dtype, w_dtype) -> QuantPlan:
    """Raise ``ValueError`` unless the kernel takes an (m, k) x (k, n)
    product of these dtypes; return its plan.  A pure function of the
    shapes: K and N multiples of 128, an int8/fp8 weight, f32/bf16/f16
    activations, and the grid within the card's limits."""
    if not supported(k, n, w_dtype):
        raise ValueError(
            f"quant_matmul_kernel requires lane-aligned K/N (multiples of "
            f"{_LANES}) and an int8/fp8 weight; got K={k}, N={n}, "
            f"dtype={w_dtype}")
    if x_dtype not in _X_CODES:
        raise ValueError(f"unsupported activation dtype {x_dtype}")
    if m < 1:
        raise ValueError(f"M must be at least 1, got {m}")
    plan = quant_plan(m, k, n, x_dtype)
    if plan.n_tiles > _GRID_YZ or plan.splits > _GRID_YZ or \
            plan.m_tiles >= 2 ** 31:
        raise ValueError(f"quant_matmul_kernel: grid {plan} past the "
                         f"card's limits")
    return plan


def check_kernel_args(x2d, w_q, scale) -> QuantPlan:
    """Raise ``ValueError`` unless the kernel takes these arguments:
    shapes, dtypes, geometry, devices, contiguity and 16-byte
    alignment; return the launch's plan."""
    if x2d.dim() != 2 or w_q.dim() != 2 or scale.dim() != 1:
        raise ValueError("x must be (M, K), w_q (K, N) and scale (N,)")
    m, k = x2d.shape
    if w_q.shape[0] != k or scale.shape[0] != w_q.shape[1]:
        raise ValueError(f"shapes x {tuple(x2d.shape)}, w_q "
                         f"{tuple(w_q.shape)}, scale {tuple(scale.shape)} "
                         f"do not agree")
    plan = check_geometry(max(m, 1), k, w_q.shape[1], x2d.dtype, w_q.dtype)
    if scale.dtype != torch.float32:
        raise ValueError(f"scale must be float32, got {scale.dtype}")
    for name, t in (("x", x2d), ("w_q", w_q), ("scale", scale)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != x2d.device:
            raise ValueError(f"{name} is on {t.device}, x on {x2d.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return plan


_launch_fn = None


def _lib():
    """The kernel's C entry point, built and bound at first use; its tile
    checked against :func:`quant_plan`'s."""
    global _launch_fn
    if _launch_fn is None:
        from ._build import load
        lib = load("quant_matmul")
        lib.quant_matmul_geometry.argtypes = [ctypes.c_int]
        tile = tuple(lib.quant_matmul_geometry(i) for i in range(5))
        want = (TILE_M, TILE_N, CHUNK_ROWS, _F32_TILE_M, _F32_TILE_N)
        if tile != want:
            raise RuntimeError(f"quant_matmul kernel tiles {tile} != the "
                               f"plan's {want}")
        fn = lib.quant_matmul_launch
        # c_void_p for every pointer and the stream, or ctypes passes them
        # as 32-bit ints and cuts them
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ci, ci, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, vp]
        fn.restype = ctypes.c_int
        _launch_fn = fn
    return _launch_fn


# per device: the split's partials ((hi, lo) f32 pairs) and its arrival
# counters (int32, zero; each launch leaves them zero), grown to the
# largest launch
_part = {}
_counts = {}


def _split_scratch(device, plan, m, n):
    """Pointers to the split's scratch, or (None, None) for a walk."""
    if not plan.split:
        return None, None
    part, counts = _part.get(device), _counts.get(device)
    need = 2 * plan.chunks * m * n
    if part is None or part.numel() < need:
        part = _part[device] = torch.empty(need, dtype=torch.float32,
                                           device=device)
    need = plan.m_tiles * plan.n_tiles
    if counts is None or counts.numel() < need:
        counts = _counts[device] = torch.zeros(need, dtype=torch.int32,
                                               device=device)
    return part.data_ptr(), counts.data_ptr()


def quant_matmul_kernel(x2d, w_q, scale):
    """Launch the Hopper kernel on PyTorch's current stream; ``x2d`` is
    (M, K), returns (M, N) in x's dtype.  Raises on arguments the kernel
    does not take or a launch the device refuses."""
    global launches, f32_launches
    if x2d.device.type != "cuda":
        raise ValueError(f"the quant_matmul kernel runs on CUDA tensors, "
                         f"got {x2d.device}")
    plan = check_kernel_args(x2d, w_q, scale)
    m, k = x2d.shape
    n = w_q.shape[1]
    out = torch.empty(m, n, dtype=x2d.dtype, device=x2d.device)
    if m == 0:
        return out
    fn = _launch_fn or _lib()
    dev = x2d.device.index
    with torch.cuda.device(dev):
        part, counts = _split_scratch(x2d.device, plan, m, n)
        # the stream's handle as an int, without a torch.cuda.Stream
        # object per call (the serving path makes 48 calls a forward)
        err = fn(_X_CODES[x2d.dtype], _W_CODES[w_q.dtype], x2d.data_ptr(),
                 w_q.data_ptr(), scale.data_ptr(), out.data_ptr(), part,
                 counts, m, k, n, plan.chunks_per_block,
                 torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"quant_matmul kernel launch failed: "
                           f"CUDA error {err}")
    launches += 1
    if plan.route == "f32":
        f32_launches += 1
    return out


def kernel_weight_args(w_q, scale):
    """The weight and scale as the kernel takes them: ``w_q`` contiguous
    (a transposed or sliced view is copied) and ``scale`` contiguous f32
    (the JAX package casts the scale to f32 before its kernel).
    ``WeightOnlyLinear`` holds both so from its load on, so its calls pass
    through untouched."""
    if not w_q.is_contiguous():
        w_q = w_q.contiguous()
    if scale.dtype != torch.float32 or not scale.is_contiguous():
        scale = scale.to(torch.float32).contiguous()
    return w_q, scale


def quant_matmul(x, w_q, scale, bias=None):
    """``x`` (..., K) in bf16/f32 times the quantized ``w_q`` (K, N) with
    per-column ``scale`` (N,), plus ``bias`` (N,) in x's dtype.  Dispatch:
    unsupported geometry or a CPU tensor -> the plain version; a CUDA
    tensor -> the kernel (the weight and scale through
    :func:`kernel_weight_args`), or raise."""
    k, n = w_q.shape
    lead = x.shape[:-1]
    x2d = x.reshape(-1, k)
    if x.device.type == "cpu" or not supported(k, n, w_q.dtype):
        out = quant_matmul_ref(x2d, w_q, scale)
    elif x.device.type == "cuda":
        out = quant_matmul_kernel(x2d.contiguous(),
                                  *kernel_weight_args(w_q, scale))
    else:
        raise ValueError(f"quant_matmul: unsupported device {x.device}")
    out = out.reshape(*lead, n)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out
