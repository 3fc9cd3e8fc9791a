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
  points: decode widths (``s < 16``), at any ``D``, go to the split decode
  kernel (chunks of 64 rows over blocks, the chunks merged inside the
  launch; past ``D = 256`` the row in column slices), prefill chunks to the
  chunk kernels; :func:`split_plan` is the split kernel's head grouping,
  chunk count, column slices and shared memory.  Every kernel has a TMA
  instance (whole-page boxes, where rows are a multiple of 16 bytes and,
  for the chunk kernels, pages hold a multiple of 8 rows a box) and a
  gathered one (the same consumers, rows loaded one by one through the
  page table: pages of 12, ``D = 36``, ``D = 260``, f32 ``D % 4 != 0``).
  :func:`tile_route` names the kernel of each shape (one of
  :data:`TILE_ROUTES`, each counted in :data:`kernel_launches`), the
  pure-Python mirror of the library's ``paged_attention_route``;
  :func:`tc_plan` mirrors the TMA launch plan of the bf16/f16 prefill
  kernel (paged TMA + wgmma, at every D), :func:`tf32_plan` that of the f32
  prefill kernel (paged TMA + 3xTF32 wgmma, at every D) and
  :func:`gather_plan` the gathered instances of both.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

_NEG_INF = -1e30  # large-but-finite, matching the dense composition

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# kernel launches since the last reset, one count per entry point (the
# smoke run reads them to prove the serving path went through the kernels):
# "paged_decode" the split decode kernel, "paged_attention" the chunk kernels
launches = {"paged_decode": 0, "paged_attention": 0}
# The kernels, in the order of the library's paged_attention_route: through
# "paged_decode" the split decode kernel on TMA boxes (``split``: decode
# widths with 16-byte rows) and its gathered instance (``split_g``: the other
# rows), through "paged_attention" the bf16/f16 prefill kernel on paged TMA
# + wgmma up to D = 256 (``tiles_tc``) and past it in 256-column chunks
# (``tiles_wide_tc``), their gathered instances (``tiles_tc_g``,
# ``tiles_wide_tc_g``: rows or pages no TMA box takes), and the f32 prefill
# kernel on paged TMA + 3xTF32 wgmma at every D (``tiles_tf32``) and its
# gathered instance (``tiles_tf32_g``).  Each launch counts once here and
# once in ``launches``.
TILE_ROUTES = ("split", "split_g", "tiles_tc", "tiles_wide_tc", "tiles_tc_g",
               "tiles_wide_tc_g", "tiles_tf32", "tiles_tf32_g")
kernel_launches = dict.fromkeys(TILE_ROUTES, 0)

SPLIT_ROWS = 64          # logical rows of a split-decode chunk
SPLIT_MAX_WIDTH = 15     # widths below the tensor-core kernel's 16
SPLIT_SLICE_BYTES = 512  # past D = 256: a column slice's row, at most
SPLIT_STAGES = 2         # past D = 256: the ring of K / V slices
SMEM_LIMIT = 232_448     # the H100's dynamic shared memory a block
TF32_RAW_SLOTS = 4       # the f32 prefill kernel's rings: raw f32 boxes,
TF32_OP_SLOTS = 4        # and hi / lo operand tiles (each 8 past D = 256)
TF32_WIDE_CHUNK = 160    # past D = 256: the f32 kernel's output chunks
GATHER_PRODUCER = 128    # the bf16/f16 kernel's gathered producer threads


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


def uses_split_decode(s: int) -> bool:
    """Whether the split decode kernel takes a call of width ``s`` (else
    the chunk kernels): widths below 16, at any D and row alignment (rows
    that are not a multiple of 16 bytes on its gathered instance)."""
    return s <= SPLIT_MAX_WIDTH


def _pow2_part(page_size: int) -> int:
    """The largest power of two that divides ``page_size``, up to 64 (the
    split kernel's box rows, and the TMA prefill kernels')."""
    return min(page_size & -page_size, 64)


class SplitPlan(NamedTuple):
    """The split decode kernel's plan (:func:`split_plan`)."""
    G: int            # heads a group (a TMA box's columns)
    groups: int       # ceil(H / G)
    chunks: int       # the table's chunks of SPLIT_ROWS logical rows
    slices: int       # column slices of a group's row
    slice_cols: int   # columns of a slice
    smem: int         # dynamic shared memory, bytes
    gathered: bool = False   # rows not a multiple of 16 bytes


def split_plan(heads: int, head_dim: int, dtype, page_size: int,
               pages_per_slot: int, width: int = 1) -> SplitPlan:
    """The split decode kernel's plan at ``width`` queries.  Up to D = 256
    heads in groups of G (a TMA box of G * D <= 256 columns and at most
    512 bytes a row where D allows, G <= 8, the groups balanced), one
    slice of G * D columns, K and V of a chunk staged whole.  Past 256 one
    head a group (G = 1) in balanced column slices, each slice's row a
    multiple of 128 bytes up to ``SPLIT_SLICE_BYTES``, streamed through a
    ring of ``SPLIT_STAGES`` entries, so shared memory does not grow with
    D.  Rows that are not a multiple of 16 bytes take the gathered
    instance (``gathered``): the same plan, a chunk's rows one by one, up
    to 256 each head's row padded in shared memory to the next multiple of
    16 bytes.  ``chunks``: the table's chunks of ``SPLIT_ROWS`` logical
    rows; ``smem`` as the kernel lays it out (``split::smem_bytes``)."""
    elem = dtype.itemsize
    gathered = head_dim * elem % 16 != 0
    chunks = -(-(page_size * pages_per_slot) // SPLIT_ROWS)
    if head_dim > 256:
        slices = -(-head_dim * elem // SPLIT_SLICE_BYTES)
        unit = 128 // elem
        cols = -(-(-(-head_dim // slices)) // unit) * unit
        smem = (SPLIT_STAGES * SPLIT_ROWS * cols * elem
                + 4 * (width * cols + width * SPLIT_ROWS + 2 * 8 * width + 1)
                + 8 * SPLIT_STAGES + 8 + 128)
        return SplitPlan(1, heads, chunks, slices, cols, smem, gathered)
    g = max(1, min(heads, 8, 512 // (head_dim * elem), 256 // head_dim))
    g = -(-heads // -(-heads // g))
    vec = 16 // elem
    hs = -(-head_dim // vec) * vec            # a head's columns in shared
    if gathered:                              # dense rows, one a "box"
        pb, bstride = 1, g * hs * elem
    else:
        pb = _pow2_part(page_size)
        bstride = -(-pb * g * head_dim * elem // 128) * 128
    smem = (2 * (SPLIT_ROWS // pb) * bstride
            + 4 * (width * g * hs + width * g * SPLIT_ROWS
                   + 4 * width * g + 1) + 8 + 16 + 128)
    # the kernel's own counts: ceil(H / G) groups, ceil(T / rows) chunks
    return SplitPlan(g, -(-heads // g), chunks, 1, g * head_dim, smem,
                     gathered)


def tile_route(s: int, head_dim: int, dtype, page_size: int) -> str:
    """The kernel that runs width ``s``, ``head_dim`` and pages of
    ``page_size`` rows in ``dtype`` (one of :data:`TILE_ROUTES`): the
    mirror of the library's ``paged_attention_route``.  TMA instances take
    rows a box addresses (a multiple of 16 bytes: 8 elements in bf16/f16,
    4 in f32), the chunk kernels' over pages of a multiple of 8 rows (a
    128-byte-swizzled box of 8 rows lands 1024-byte aligned); the gathered
    instances (``_g``) the other rows and pages."""
    elem = dtype.itemsize
    if uses_split_decode(s):
        return "split" if head_dim * elem % 16 == 0 else "split_g"
    tma = head_dim * elem % 16 == 0 and _pow2_part(page_size) >= 8
    if dtype == torch.float32:
        return "tiles_tf32" if tma else "tiles_tf32_g"
    route = "tiles_tc" if head_dim <= 256 else "tiles_wide_tc"
    return route if tma else route + "_g"


def _tc_layout(B, s, H, head_dim):
    """``paged_attention_tc``'s launch plan, TMA and gathered instances
    alike (``pw::smem_of``): output chunk, consumers, grid, slices, q
    residency and shared memory."""
    box = 64 * 128                            # a [64][64] 2-byte box
    nc = 64 if head_dim <= 64 else 128 if head_dim <= 128 else 256
    kw = 2 if s > 64 and nc <= 128 else 1
    slices, chunks = -(-head_dim // 64), -(-head_dim // nc)
    resident = head_dim <= 1024
    k_entry = box * (1 if resident else 2)
    bars = ((kw * slices * box if resident else 0) + 4 * k_entry
            + 2 * (nc // 64) * box)
    return dict(chunk_cols=nc, chunks=chunks, consumers=kw,
                grid=(B * -(-s // (64 * kw)) * H * chunks, 1, 1),
                slices=slices, q_resident=resident,
                smem=1024 + bars + (1 + 2 * 4 + 2 * 2) * 8)


def tc_plan(B: int, s: int, H: int, head_dim: int, page_size: int,
            dtype) -> dict:
    """The launch plan of ``paged_attention_tc``'s TMA instance, the
    bf16/f16 prefill kernel on paged TMA + wgmma (routes ``tiles_tc`` and
    ``tiles_wide_tc``; ``ValueError`` for a shape another instance or
    kernel takes), as the kernel lays it out: the output ``chunk_cols``
    (D's padded width 64, 128 or 256 up to 256, chunks of 256 past it) and
    ``chunks``, ``consumers`` (warpgroups, each on its own 64-row q tile:
    two up to a chunk of 128 columns where the width has more than one
    tile, else one), ``grid`` (slots x blocks of ``consumers`` q tiles x
    heads x chunks in grid.x), ``threads`` (the consumers and a producer
    warp), the K/V boxes (``box_rows`` = the largest power of two dividing
    the page, up to 64; ``boxes`` a 64-row tile, 64 columns of one head
    each, 128 bytes a row), the 64-column ``slices``, whether q's slices
    stay resident (up to D = 1024) and ``smem`` as ``pw::smem_of`` (each
    consumer's q slices, a K ring of 4 entries -- with q's slice beside
    each where q streams --, a V ring of 2 entries of ``chunk_cols / 64``
    boxes, the barriers)."""
    route = tile_route(s, head_dim, dtype, page_size)
    if route not in ("tiles_tc", "tiles_wide_tc"):
        raise ValueError(f"s={s} D={head_dim} P={page_size} {dtype} runs "
                         f"{route}")
    plan = _tc_layout(B, s, H, head_dim)
    pb = _pow2_part(page_size)
    return dict(plan, route=route, threads=128 * plan["consumers"] + 32,
                box_rows=pb, boxes=64 // pb, box_bytes=128)


def _tf32_layout(B, s, H, head_dim):
    """``paged_attention_tf32``'s launch plan, TMA and gathered instances
    alike (``ptf::smem``)."""
    box = 64 * 128                            # a [64][32] f32 box
    dp = (64 if head_dim <= 64 else 128 if head_dim <= 128
          else 256 if head_dim <= 256 else 0)
    kw = 2 if s > 64 and dp and dp <= 128 else 1
    raw, ops = (TF32_RAW_SLOTS, TF32_OP_SLOTS) if dp else (8, 8)
    chunks = 1 if dp else -(-head_dim // TF32_WIDE_CHUNK)
    return dict(dp=dp or TF32_WIDE_CHUNK, chunks=chunks,
                slices=dp // 32 if dp else -(-head_dim // 32),
                q_resident=bool(dp), consumers=kw, threads=128 * (1 + kw),
                grid=(-(-s // (64 * kw)) * B * H * chunks, 1, 1),
                smem=1024 + (2 * kw * dp // 32 + raw + 2 * ops) * box
                + 8 * (2 + raw + 2 * ops))


def tf32_plan(B: int, s: int, H: int, head_dim: int, page_size: int) -> dict:
    """The launch plan of ``paged_attention_tf32``'s TMA instance
    (``ValueError`` for a shape another instance or kernel takes), as the
    kernel lays it out: the padded width ``dp`` (64, 128 or 256; past 256
    output ``chunks`` of 160 columns, each recomputing S over all of D) in
    32-column ``slices`` (S's slices: D / 32 past 256), ``consumers``
    (warpgroups, each on its own 64-row q tile: two up to 128 where the
    chunk has more than one tile, else one), ``grid`` (slots x blocks of
    ``consumers`` q tiles x heads x chunks in grid.x), ``threads`` (the
    consumers and a producer warpgroup), the K/V boxes (``box_rows`` = the
    largest power of two dividing the page, up to 64; ``boxes`` a 64-row
    tile, 32 f32 columns of one head each, 128 bytes a row), and ``smem``
    as ``ptf::smem`` (q's hi and lo tiles per consumer -- past 256 q
    streams through the rings, 8 slots each --, the raw box slots, the
    hi/lo operand slots, 8 KB a tile, the barriers)."""
    route = tile_route(s, head_dim, torch.float32, page_size)
    if route != "tiles_tf32":
        raise ValueError(f"s={s} D={head_dim} P={page_size} f32 runs {route}")
    pb = _pow2_part(page_size)
    return dict(_tf32_layout(B, s, H, head_dim), route=route, box_rows=pb,
                boxes=64 // pb, box_bytes=128)


def gather_plan(B: int, s: int, H: int, head_dim: int, page_size: int,
                dtype) -> dict:
    """The launch plan of a prefill kernel's gathered instance (routes
    ``tiles_tc_g``, ``tiles_wide_tc_g``, ``tiles_tf32_g``; ``ValueError``
    for a shape a TMA instance or the split kernel takes): the TMA
    instance's blocks, grid, rings and ``smem`` (the tiles land in the same
    layout), ``threads`` with the gathered producer (bf16/f16: the
    consumers and ``GATHER_PRODUCER`` threads, a warpgroup, where the TMA
    instance has one warp; f32: the same producer warpgroup), and
    ``align``, the bytes of the widest copy a
    row's alignment allows (4, 8 or 16; 2 for an odd D in bf16/f16, whose
    rows move by elements)."""
    route = tile_route(s, head_dim, dtype, page_size)
    if route not in ("tiles_tc_g", "tiles_wide_tc_g", "tiles_tf32_g"):
        raise ValueError(f"s={s} D={head_dim} P={page_size} {dtype} runs "
                         f"{route}")
    nbytes = head_dim * dtype.itemsize
    align = min(nbytes & -nbytes, 16)
    if dtype == torch.float32:
        return dict(_tf32_layout(B, s, H, head_dim), route=route,
                    align=align)
    plan = _tc_layout(B, s, H, head_dim)
    return dict(plan, route=route, align=align,
                threads=128 * plan["consumers"] + GATHER_PRODUCER)


_fns = {}


def _lib(name):
    """A C entry point of the kernel library, built and bound at first
    use: ``paged_attention_launch`` (the chunk kernels),
    ``paged_attention_launch_as`` (the same with the instance named) or
    ``paged_decode_launch`` (the split decode kernel)."""
    if name not in _fns:
        from ._build import load
        fn = getattr(load("paged_attention"), name)
        # c_void_p for every pointer and the stream, or ctypes passes them
        # as 32-bit ints and cuts them
        vp, ci = ctypes.c_void_p, ctypes.c_int
        ptrs = 9 if name == "paged_decode_launch" else 6
        ints = 8 if name == "paged_decode_launch" else 7
        lead = 2 if name == "paged_attention_launch_as" else 1
        fn.argtypes = ([ci] * lead + [vp] * ptrs + [ci] * ints
                       + [ctypes.c_float, vp])
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


def library_route(s, head_dim, dtype, page_size) -> str:
    """The kernel the library routes the shape to (its
    ``paged_attention_route``; builds the library at first use)."""
    code = _lib_int("paged_attention_route", _DTYPE_CODES[dtype], s,
                    head_dim, page_size)
    if code < 0:
        raise RuntimeError(f"no paged kernel for s={s} D={head_dim} "
                           f"P={page_size} {dtype}")
    return TILE_ROUTES[code]


def _lib_int(name, *args) -> int:
    """An int-valued C function of the library (built at first use)."""
    from ._build import load
    fn = getattr(load("paged_attention"), name)
    fn.argtypes = [ctypes.c_int] * len(args)
    fn.restype = ctypes.c_int
    return fn(*args)


def library_tc_smem(head_dim, s) -> int:
    """``paged_attention_tc``'s dynamic shared memory at ``head_dim`` and
    width ``s`` as the library computes it."""
    return _lib_int("paged_attention_tc_smem", head_dim, s)


def library_tf32_smem(head_dim, s) -> int:
    """``paged_attention_tf32``'s dynamic shared memory at ``head_dim``
    and width ``s`` as the library computes it."""
    return _lib_int("paged_attention_tf32_smem", head_dim, s)


def library_split_smem(dtype, s, head_dim, G, page_size) -> int:
    """The split decode kernel's dynamic shared memory as the library
    computes it."""
    return _lib_int("paged_decode_split_smem", _DTYPE_CODES[dtype], s,
                    head_dim, G, page_size)


def _launch(q, k_pool, v_pool, page_table, lengths, route, instance=None):
    """One launch of the kernel of ``route`` on PyTorch's current stream
    (``instance``: ``gathered`` for ``paged_attention_launch_as``);
    returns ``(B, s, H, D)`` in q's dtype, raises on a refused launch."""
    B, s, H, D = q.shape
    N, P = k_pool.shape[:2]
    maxp = page_table.shape[1]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        head = (_DTYPE_CODES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
                v_pool.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
                out.data_ptr())
        if route in ("split", "split_g"):
            plan = split_plan(H, D, q.dtype, P, maxp)
            err = _lib("paged_decode_launch")(
                *head, *_split_scratch(q, H, D, plan.chunks, plan.groups),
                B, s, H, D, N, P, maxp, plan.G, 1.0 / math.sqrt(D), stream)
        elif instance is None:
            err = _lib("paged_attention_launch")(
                *head, B, s, H, D, N, P, maxp, 1.0 / math.sqrt(D), stream)
        else:
            err = _lib("paged_attention_launch_as")(
                instance, *head, B, s, H, D, N, P, maxp,
                1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"CUDA error {err}")
    return out


def paged_attention_kernel(q, k_pool, v_pool, page_table, lengths):
    """Launch a Hopper kernel on PyTorch's current stream: the split decode
    kernel where :func:`uses_split_decode` holds, else the chunk kernels
    (the kernel and instance :func:`tile_route` names, counted under its
    name); returns ``(B, s, H, D)`` in q's dtype.  Raises on arguments the
    kernels do not take or a launch the device refuses."""
    if q.device.type != "cuda":
        raise ValueError(f"the paged-attention kernel runs on CUDA "
                         f"tensors, got {q.device}")
    check_kernel_args(q, k_pool, v_pool, page_table, lengths)
    route = tile_route(q.shape[1], q.shape[3], q.dtype, k_pool.shape[1])
    out = _launch(q, k_pool, v_pool, page_table, lengths, route)
    launches["paged_decode" if route.startswith("split")
             else "paged_attention"] += 1
    kernel_launches[route] += 1
    return out


def chunk_instance(q, k_pool, v_pool, page_table, lengths, gathered):
    """The chunk kernel of q's dtype through the instance named
    (``gathered`` True: the gathered producer, False: the TMA one, which
    refuses rows and pages its boxes cannot take), not counted in
    :data:`kernel_launches`: ``chip_smoke.py`` holds the two instances bit
    for bit at a shape both take."""
    if q.device.type != "cuda" or q.shape[1] <= SPLIT_MAX_WIDTH:
        raise ValueError("chunk_instance takes CUDA tensors at chunk widths")
    check_kernel_args(q, k_pool, v_pool, page_table, lengths)
    return _launch(q, k_pool, v_pool, page_table, lengths, "chunk",
                   int(bool(gathered)))


def _int32(t):
    return t if t.dtype == torch.int32 and t.is_contiguous() \
        else t.to(torch.int32).contiguous()


def kernel_index_args(page_table, lengths):
    """The page table and lengths as the kernels take them: int32 and
    contiguous (the JAX package casts both to int32; an int64 table or
    lengths, torch's default integer type, is cast here).  The serving
    engine stages both as int32 already, so its ticks pass through
    untouched."""
    return _int32(page_table), _int32(lengths)


def paged_attention(q, k_pool, v_pool, page_table, lengths):
    """Dispatch by device: the plain version for CPU tensors, the Hopper
    kernels for CUDA tensors (every width; the table and lengths through
    :func:`kernel_index_args`), anything else raises."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, page_table, lengths)
    if q.device.type == "cuda":
        return paged_attention_kernel(q, k_pool, v_pool,
                                      *kernel_index_args(page_table, lengths))
    raise ValueError(f"paged_attention: unsupported device {q.device}")
