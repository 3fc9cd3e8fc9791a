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
- :func:`uses_split_decode` is the routing between the file's two entry
  points: decode widths (``s < 16``) with 16-byte rows up to ``D = 256``
  go to the split decode kernel (chunks of 64 rows over blocks, whole-page
  TMA loads, the chunks merged inside the launch), the rest to the tile
  kernels; :func:`split_plan` is the split kernel's head grouping and
  chunk count.
"""

from __future__ import annotations

import ctypes
import math

import torch

_NEG_INF = -1e30  # large-but-finite, matching the dense composition

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# kernel launches since the last reset, one count per entry point (the
# smoke run reads them to prove the serving path went through the kernels):
# "paged_decode" the split decode kernel, "paged_attention" the tile kernels
launches = {"paged_decode": 0, "paged_attention": 0}

SPLIT_ROWS = 64          # logical rows of a split-decode chunk
SPLIT_MAX_WIDTH = 15     # widths below the tensor-core kernel's 16


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


def check_geometry(q_shape, pool_shapes, dtypes, table_shape, table_dtype,
                   lengths_shape, lengths_dtype) -> None:
    """Raise ``ValueError`` unless the kernel takes arguments of these
    shapes and dtypes (a pure function, which the CPU tests call): q
    ``(B, s, H, D)``, both pools ``(N, P, H, D)``, one float dtype, an
    int32 ``(B, pages_per_slot)`` table and int32 ``(B,)`` lengths: any
    head width D >= 1 (past 256 the kernels take it in slices), width ``s``
    and page size ``P``."""
    if len(q_shape) != 4 or any(len(p) != 4 for p in pool_shapes):
        raise ValueError("q must be (B, s, H, D) and the pools (N, P, H, D)")
    B, s, H, D = q_shape
    N, P = pool_shapes[0][:2]
    if any(tuple(p) != (N, P, H, D) for p in pool_shapes):
        raise ValueError(f"pool shapes {[tuple(p) for p in pool_shapes]} do "
                         f"not match q {tuple(q_shape)}")
    if dtypes[0] not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {dtypes[0]}")
    if any(d != dtypes[0] for d in dtypes):
        raise ValueError(f"q and the pools must share one dtype, got "
                         f"{'/'.join(str(d) for d in dtypes)}")
    if (len(table_shape) != 2 or table_shape[0] != B or table_shape[1] < 1
            or table_dtype != torch.int32):
        raise ValueError("page_table must be (B, pages_per_slot) int32")
    if tuple(lengths_shape) != (B,) or lengths_dtype != torch.int32:
        raise ValueError("lengths must be (B,) int32")
    if D < 1 or P < 1 or s < 1:
        raise ValueError(f"kernel geometry D={D} P={P} s={s}: needs D >= 1, "
                         f"P >= 1, s >= 1")


def check_kernel_args(q, k_pool, v_pool, page_table, lengths) -> None:
    """Raise ``ValueError`` unless the kernel takes these arguments:
    :func:`check_geometry`, then contiguity, device and alignment."""
    check_geometry(tuple(q.shape), (tuple(k_pool.shape), tuple(v_pool.shape)),
                   (q.dtype, k_pool.dtype, v_pool.dtype),
                   tuple(page_table.shape), page_table.dtype,
                   tuple(lengths.shape), lengths.dtype)
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("page_table", page_table), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def uses_split_decode(s: int, head_dim: int, dtype) -> bool:
    """Whether the split decode kernel takes a call (else the tile
    kernels): widths below 16, rows a multiple of 16 bytes, D <= 256."""
    elem = torch.empty((), dtype=dtype).element_size()
    return (s <= SPLIT_MAX_WIDTH and head_dim <= 256
            and head_dim * elem % 16 == 0)


def split_plan(heads: int, head_dim: int, dtype, page_size: int,
               pages_per_slot: int):
    """``(G, groups, chunks)`` of the split decode kernel: heads in groups
    of G (a TMA box of G * D <= 256 columns and at most 512 bytes a row
    where D allows, G <= 8, the groups balanced), and the table's chunks
    of ``SPLIT_ROWS`` logical rows."""
    elem = torch.empty((), dtype=dtype).element_size()
    g = max(1, min(heads, 8, 512 // (head_dim * elem), 256 // head_dim))
    g = -(-heads // -(-heads // g))
    # the kernel's own counts: ceil(H / G) groups, ceil(T / rows) chunks
    return (g, -(-heads // g),
            -(-(page_size * pages_per_slot) // SPLIT_ROWS))


_fns = {}


def _lib(name):
    """A C entry point of the kernel library, built and bound at first
    use: ``paged_attention_launch`` (the tile kernels) or
    ``paged_decode_launch`` (the split decode kernel)."""
    if name not in _fns:
        from ._build import load
        fn = getattr(load("paged_attention"), name + "_launch")
        # c_void_p for every pointer and the stream, or ctypes passes them
        # as 32-bit ints and cuts them
        vp, ci = ctypes.c_void_p, ctypes.c_int
        ptrs = 6 if name == "paged_attention" else 9
        ints = 7 if name == "paged_attention" else 8
        fn.argtypes = [ci] + [vp] * ptrs + [ci] * ints + [ctypes.c_float, vp]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


_scratch = {}


def _split_scratch(q, H, D, nch, groups):
    """The split kernel's partials (f32) and arrival counters (int32,
    zero; each launch leaves them zero), cached per geometry; none where
    the table is one chunk."""
    B, s = q.shape[:2]
    if nch == 1:
        return 0, 0, 0
    key = (q.device, B, s, H, D, nch, groups)
    if key not in _scratch:
        f32 = dict(dtype=torch.float32, device=q.device)
        _scratch[key] = (torch.empty(B * nch * s * H * D, **f32),
                         torch.empty(B * nch * s * H * 2, **f32),
                         torch.zeros(B * groups, dtype=torch.int32,
                                     device=q.device))
    return tuple(t.data_ptr() for t in _scratch[key])


def paged_attention_kernel(q, k_pool, v_pool, page_table, lengths):
    """Launch a Hopper kernel on PyTorch's current stream: the split decode
    kernel where :func:`uses_split_decode` holds, else the tile kernels;
    returns ``(B, s, H, D)`` in q's dtype.  Raises on arguments the kernels
    do not take or a launch the device refuses."""
    if q.device.type != "cuda":
        raise ValueError(f"the paged-attention kernel runs on CUDA "
                         f"tensors, got {q.device}")
    check_kernel_args(q, k_pool, v_pool, page_table, lengths)
    B, s, H, D = q.shape
    N, P = k_pool.shape[:2]
    maxp = page_table.shape[1]
    out = torch.empty_like(q)
    split = uses_split_decode(s, D, q.dtype)
    name = "paged_decode" if split else "paged_attention"
    fn = _lib(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        head = (_DTYPE_CODES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
                v_pool.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
                out.data_ptr())
        if split:
            G, groups, nch = split_plan(H, D, q.dtype, P, maxp)
            err = fn(*head, *_split_scratch(q, H, D, nch, groups), B, s, H,
                     D, N, P, maxp, G, 1.0 / math.sqrt(D), stream)
        else:
            err = fn(*head, B, s, H, D, N, P, maxp, 1.0 / math.sqrt(D),
                     stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"CUDA error {err}")
    launches[name] += 1
    return out


def paged_attention(q, k_pool, v_pool, page_table, lengths):
    """Dispatch by device: the plain version for CPU tensors, the Hopper
    kernels for CUDA tensors (every width), anything else raises."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, page_table, lengths)
    if q.device.type == "cuda":
        return paged_attention_kernel(q, k_pool, v_pool, page_table, lengths)
    raise ValueError(f"paged_attention: unsupported device {q.device}")
