"""Paged attention: the KV write through a page table, the plain PyTorch
reference, and the dispatch to the hand-written Hopper kernel.

Port of the JAX package's ``incubate/nn/kernels/paged_attention.py``.
The serving engine keeps each layer's cache as a global page pool
``(num_pages, page_size, heads, head_dim)`` and a per-slot page table
``(B, pages_per_slot)`` of physical page ids (``inference/paged.py`` owns
the host-side allocator).

- :func:`paged_write` scatters a window of K or V rows into the pool
  through the table, IN PLACE (JAX rebuilt the pool functionally; the
  port saves one pool copy per layer per step).
- :func:`paged_attention_ref` is the plain version, any query width:
  gather the slot's pages into a contiguous ``(B, T, H, D)`` view and run
  the dense static-cache composition (same einsums, same ``-1e30`` mask,
  same softmax, in the JAX reference's op order).  CPU tensors take it.
- :func:`paged_attention` dispatches: a CPU tensor goes to the plain
  version; a CUDA tensor launches ``csrc/paged_attention.cu`` at every
  width (decode steps and prefill chunks alike) or raises.  There is no
  fallback from the card to the plain version.
"""

from __future__ import annotations

import ctypes
import math

import torch

_NEG_INF = -1e30  # large-but-finite, matching the dense composition

# the kernel's geometry limits (csrc/paged_attention.cu)
MAX_HEAD_DIM = 256
MAX_PAGE_SIZE = 64
MAX_WIDTH = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# kernel launches since the last reset (the smoke run reads it to prove
# the serving path went through the kernel)
launches = 0


def paged_write(pool: torch.Tensor, vals: torch.Tensor,
                page_table: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Write ``vals`` (B, s, H, D) at logical rows ``[pos, pos+s)`` of each
    slot, in place: row ``r`` of slot ``b`` lives at physical row
    ``page_table[b, r // P] * P + r % P`` of the flattened pool.  One
    scatter covers every slot.  Inactive slots' table rows are NULL (page
    0), so their writes land in the reserved scratch page.  Page indices
    past the table clamp to its last column (the engine's capacity check
    keeps live slots inside their table).
    Returns ``pool``."""
    N, P, H, D = pool.shape
    B, s = vals.shape[:2]
    positions = pos.to(torch.long)[:, None] \
        + torch.arange(s, device=pool.device)[None, :]
    page_idx = (positions // P).clamp_(0, page_table.shape[1] - 1)
    phys = page_table.to(torch.long).gather(1, page_idx) * P + positions % P
    pool.view(N * P, H, D).index_copy_(
        0, phys.reshape(-1), vals.reshape(B * s, H, D).to(pool.dtype))
    return pool


def paged_attention_ref(q, k_pool, v_pool, page_table, lengths):
    """Plain paged attention, any query width: gather + the dense
    static-cache composition (``models/gpt.py``).  ``lengths`` is each
    slot's write offset this call (query ``i`` sits at global position
    ``lengths[b] + i`` and attends ``kpos <= qpos``); the current tokens'
    K/V are already in the pool (write before read)."""
    N, P, H, D = k_pool.shape
    B, s = q.shape[:2]
    dev = q.device
    rows = (page_table.to(torch.long)[:, :, None] * P
            + torch.arange(P, device=dev)[None, None, :]).reshape(B, -1)
    kb = k_pool.reshape(N * P, H, D)[rows]          # (B, T, H, D)
    vb = v_pool.reshape(N * P, H, D)[rows]
    qpos = lengths.to(torch.long)[:, None] \
        + torch.arange(s, device=dev)[None, :]
    kpos = torch.arange(rows.shape[1], device=dev)
    mask = (kpos[None, None, :] <= qpos[..., None])[:, None]   # (B,1,s,T)
    scale = 1.0 / math.sqrt(D)
    logits = torch.einsum("bshe,bthe->bhst", q, kb.to(q.dtype)) * scale
    logits = logits.masked_fill(~mask, _NEG_INF)
    probs = torch.softmax(logits, -1)
    return torch.einsum("bhst,bthe->bshe", probs, vb.to(probs.dtype))


def check_kernel_args(q, k_pool, v_pool, page_table, lengths) -> None:
    """Raise ``ValueError`` unless the kernel takes these arguments:
    shapes, dtypes, contiguity, alignment and the geometry limits
    (``D <= 256``, ``D % 8 == 0``, ``P <= 64``, width ``s <= 64``)."""
    if q.dim() != 4 or k_pool.dim() != 4:
        raise ValueError("q must be (B, s, H, D) and the pools (N, P, H, D)")
    B, s, H, D = q.shape
    N, P = k_pool.shape[:2]
    if tuple(k_pool.shape) != (N, P, H, D) or v_pool.shape != k_pool.shape:
        raise ValueError(f"pool shapes {tuple(k_pool.shape)}/"
                         f"{tuple(v_pool.shape)} do not match q {tuple(q.shape)}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {q.dtype}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError("q and the pools must share one dtype, got "
                         f"{q.dtype}/{k_pool.dtype}/{v_pool.dtype}")
    if (page_table.dim() != 2 or page_table.shape[0] != B
            or page_table.shape[1] < 1 or page_table.dtype != torch.int32):
        raise ValueError("page_table must be (B, pages_per_slot) int32")
    if (lengths.shape != (B,) or lengths.dtype != torch.int32):
        raise ValueError("lengths must be (B,) int32")
    if D > MAX_HEAD_DIM or D % 8 or P > MAX_PAGE_SIZE or not 1 <= s <= MAX_WIDTH:
        raise ValueError(
            f"kernel geometry D={D} P={P} s={s}: needs D <= {MAX_HEAD_DIM}, "
            f"D % 8 == 0, P <= {MAX_PAGE_SIZE}, 1 <= s <= {MAX_WIDTH}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("page_table", page_table), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


_launch_fn = None


def _lib():
    """The kernel's C entry point, built and bound at first use."""
    global _launch_fn
    if _launch_fn is None:
        from ._build import load
        fn = load("paged_attention").paged_attention_launch
        # c_void_p for every pointer and the stream, or ctypes passes them
        # as 32-bit ints and cuts them
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ci, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci,
                       ci, ctypes.c_float, vp]
        fn.restype = ctypes.c_int
        _launch_fn = fn
    return _launch_fn


def paged_attention_kernel(q, k_pool, v_pool, page_table, lengths):
    """Launch the Hopper kernel on PyTorch's current stream; returns
    ``(B, s, H, D)`` in q's dtype.  Raises on arguments the kernel does not
    take or a launch the device refuses."""
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"the paged-attention kernel runs on CUDA "
                         f"tensors, got {q.device}")
    check_kernel_args(q, k_pool, v_pool, page_table, lengths)
    B, s, H, D = q.shape
    N, P = k_pool.shape[:2]
    out = torch.empty_like(q)
    fn = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPE_CODES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
                 v_pool.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
                 out.data_ptr(), B, s, H, D, N, P, page_table.shape[1],
                 1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"CUDA error {err}")
    launches += 1
    return out


def paged_attention(q, k_pool, v_pool, page_table, lengths):
    """Dispatch by device: the plain version for CPU tensors, the Hopper
    kernel for CUDA tensors (every width), anything else raises."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, page_table, lengths)
    if q.device.type == "cuda":
        return paged_attention_kernel(q, k_pool, v_pool, page_table, lengths)
    raise ValueError(f"paged_attention: unsupported device {q.device}")
