"""The port's weight-only quantized matmul (``paddle_hackathon_tpu_torch``)
against the JAX package's: the plain PyTorch version against the jnp
reference and against the Pallas kernel run under the Pallas interpreter
(``FORCE_KERNEL``, as ``tests/test_quant_serving.py`` runs it), with bias
and 3-D inputs, and the wrapper's argument checks and dispatch.

Tolerances are the JAX package's own: bf16 activations within one bf16
output ulp of the reference (the two sum the same exact f32 products in
different orders, then round to bf16), f32 activations ``rtol=2e-3,
atol=1e-4``.  The ulp is read exactly, 2**(floor(log2|ref|) - 7): the
JAX test's ``rtol=2**-8`` is one ulp only in the upper half of a binade,
and the port's plain version and the JAX reference, summing in different
orders, meet 1-ulp differences just above a power of two (measured here:
relative 0.0046 and 0.0058, each exactly one ulp)."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_hackathon_tpu.incubate.nn.kernels import quant_matmul as jqm
from paddle_hackathon_tpu_torch.incubate.nn.kernels import quant_matmul as tqm
from paddle_hackathon_tpu_torch.utils.convert import to_tensor

F32_TOL = dict(rtol=2e-3, atol=1e-4)
SHAPES = [(1, 128, 128), (5, 256, 384), (8, 768, 2304), (200, 384, 256)]


def _case(seed, m, k, n, wkind, xdtype):
    """numpy inputs: activations (bf16 via ml_dtypes or f32), an int8 or
    fp8-e4m3 weight and positive per-column scales."""
    rng = np.random.RandomState(seed)
    x = rng.randn(m, k).astype(np.float32)
    if xdtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
    if wkind == "int8":
        w = rng.randint(-127, 128, (k, n)).astype(np.int8)
    else:
        w = np.clip(rng.randn(k, n) * 64, -448, 448).astype(
            ml_dtypes.float8_e4m3fn)
    s = (rng.rand(n) * 0.01 + 1e-4).astype(np.float32)
    return x, w, s


def _jax_kernel(x, w, s, **kw):
    jqm.FORCE_KERNEL = True   # the Pallas kernel under the interpreter
    try:
        return jqm.quant_matmul(x, w, s, **kw)
    finally:
        jqm.FORCE_KERNEL = None


def bf16_ulps(got, ref):
    """Largest error of ``got`` in bf16 ulps of ``ref`` (both f32 arrays of
    bf16 values); zeros of ``ref`` count against an ulp of 1e-6."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    mag = np.abs(ref)
    ulp = np.where(mag > 0, 2.0 ** (np.floor(np.log2(np.where(
        mag > 0, mag, 1.0))) - 7), 1e-6)
    return float((np.abs(got - ref) / ulp).max())


def _f32(a):
    return np.asarray(a).astype(np.float32)


def _torch_f32(t):
    return t.float().numpy()


@pytest.mark.parametrize("wkind", ["int8", "fp8"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_ref_matches_jax_ref_and_kernel_bf16(shape, wkind):
    x, w, s = _case(sum(shape), *shape, wkind, "bfloat16")
    got = _torch_f32(tqm.quant_matmul_ref(to_tensor(x), to_tensor(w),
                                          to_tensor(s)))
    jx, jw, js = jnp.asarray(x), jnp.asarray(w), jnp.asarray(s)
    assert bf16_ulps(got, _f32(jqm.quant_matmul_ref(jx, jw, js))) <= 1
    assert bf16_ulps(got, _f32(_jax_kernel(jx, jw, js))) <= 1


@pytest.mark.parametrize("wkind", ["int8", "fp8"])
def test_ref_matches_jax_f32_activations(wkind):
    x, w, s = _case(1, 8, 768, 2304, wkind, "float32")
    got = tqm.quant_matmul_ref(to_tensor(x), to_tensor(w),
                               to_tensor(s)).numpy()
    jx, jw, js = jnp.asarray(x), jnp.asarray(w), jnp.asarray(s)
    np.testing.assert_allclose(got, np.asarray(jqm.quant_matmul_ref(
        jx, jw, js)), **F32_TOL)
    np.testing.assert_allclose(got, np.asarray(_jax_kernel(jx, jw, js)),
                               **F32_TOL)


@pytest.mark.parametrize("wkind", ["int8", "fp8"])
def test_bias_and_3d_input(wkind):
    """(B, S, K) activations flatten through the same product and the bias
    is added in the activation dtype, as in the JAX dispatch."""
    x, w, s = _case(2, 6, 128, 256, wkind, "bfloat16")
    x3 = x.reshape(2, 3, 128)
    b = np.random.RandomState(3).randn(256).astype(np.float32)
    got = tqm.quant_matmul(to_tensor(x3), to_tensor(w), to_tensor(s),
                           bias=to_tensor(b))
    assert got.shape == (2, 3, 256) and got.dtype == torch.bfloat16
    want = _jax_kernel(jnp.asarray(x3), jnp.asarray(w), jnp.asarray(s),
                       bias=jnp.asarray(b))
    assert bf16_ulps(_torch_f32(got), _f32(want)) <= 1
    # the bias rides outside the product, in bf16 on both sides
    plain = tqm.quant_matmul_ref(to_tensor(x), to_tensor(w), to_tensor(s))
    np.testing.assert_array_equal(
        _torch_f32(got).reshape(6, 256),
        _torch_f32(plain + to_tensor(b).to(torch.bfloat16)))


@pytest.mark.parametrize("k,n,wdtype", [
    (128, 300, torch.int8),           # N not lane-aligned
    (120, 128, torch.int8),           # K not lane-aligned
    (128, 128, torch.float32),        # not a quantized weight
])
def test_kernel_rejects_unsupported_geometry(k, n, wdtype):
    assert not tqm.supported(k, n, wdtype)
    x = torch.zeros(4, k, dtype=torch.bfloat16)
    w = torch.zeros(k, n, dtype=wdtype)
    with pytest.raises(ValueError, match="lane-aligned"):
        tqm.check_kernel_args(x, w, torch.ones(n))
    # the dispatch sends such geometry to the plain version
    out = tqm.quant_matmul(x, w, torch.ones(n))
    assert out.shape == (4, n)


def test_kernel_wrapper_refuses_cpu_tensors():
    x, w, s = _case(4, 4, 128, 128, "int8", "float32")
    with pytest.raises(ValueError, match="CUDA"):
        tqm.quant_matmul_kernel(to_tensor(x), to_tensor(w), to_tensor(s))


def test_cpu_tensor_takes_the_plain_version():
    """Supported geometry on the CPU: the plain version, bit for bit, and no
    kernel launch."""
    assert tqm.supported(256, 384, torch.int8)
    assert tqm.supported(256, 384, torch.float8_e4m3fn)
    x, w, s = _case(5, 5, 256, 384, "int8", "bfloat16")
    before = tqm.launches
    got = tqm.quant_matmul(to_tensor(x), to_tensor(w), to_tensor(s))
    assert tqm.launches == before
    np.testing.assert_array_equal(
        _torch_f32(got),
        _torch_f32(tqm.quant_matmul_ref(to_tensor(x), to_tensor(w),
                                        to_tensor(s))))


def test_ref_rounds_after_the_scale():
    """The plain version sums in f32 and rounds once, after the scale: a
    bf16 matmul would round the sum first and miss by a bf16 ulp where the
    JAX reference does not."""
    x, w, s = _case(6, 8, 768, 768, "int8", "bfloat16")
    tx, tw, ts = to_tensor(x), to_tensor(w), to_tensor(s)
    exact = (tx.double() @ tw.double()) * ts.double()
    got = tqm.quant_matmul_ref(tx, tw, ts).double()
    # within half a bf16 ulp of the exact value (plus f32 summation error)
    assert bf16_ulps(got.numpy(), exact.numpy()) <= 0.5 + 1e-3


# ---------------------------------------------------------------------------
# The Hopper kernel's schedule, order of the sum and widening, in plain
# PyTorch (the kernel itself runs only on the card: chip_smoke.py)
# ---------------------------------------------------------------------------


def widen_bits(w_q, dtype):
    """``w_q`` (int8 or fp8-e4m3) widened to ``dtype`` (bf16 or f16) as the
    kernel widens it, step by step on the bits: int8 ``b`` as the f32 with
    bits ``0x4B000000 | (b ^ 0x80)`` minus ``2**23 + 128``; e4m3 as the
    f32 with its sign at bit 31 and its 7 magnitude bits at bits 20..26,
    times ``2**120``; then bf16 as the f32's upper 16 bits, f16 rounded to
    nearest."""
    b = w_q.view(torch.uint8).to(torch.int64)
    if w_q.dtype == torch.int8:
        bits = 0x4B000000 | (b ^ 0x80)
    else:
        bits = ((b & 0x80) << 24) | ((b & 0x7F) << 20)
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    f = bits.to(torch.int32).view(torch.float32)
    f = f - 8388736.0 if w_q.dtype == torch.int8 else f * 2.0 ** 120
    if dtype == torch.bfloat16:
        return (f.view(torch.int32) >> 16).to(torch.int16).view(
            torch.bfloat16)
    return f.to(dtype)


def split_x(x, chunk_rows=tqm.CHUNK_ROWS, hi_bits=7):
    """``x`` (M, K) bf16/f16 split as the kernel splits it, ``x = x_hi +
    x_lo`` exactly: in each row's chunk of ``chunk_rows`` columns, ``x_hi``
    is each value truncated toward zero to a multiple of ``2**(E -
    hi_bits)`` (E the exponent of the chunk row's largest magnitude, read
    from x's own bits: an f16 subnormal counts as 2^-14; the kernel keeps 7
    bits below E for int8 and e4m3 weights alike) and ``x_lo`` the rest,
    both in x's dtype."""
    m, k = x.shape
    bits = x.view(torch.int16).to(torch.int32) & 0x7FFF
    top = bits.view(m, k // chunk_rows, chunk_rows).amax(-1, keepdim=True)
    if x.dtype == torch.bfloat16:
        e = top >> 7
    else:
        e = (top >> 10) + 112
    q = torch.exp2((e.clamp(min=24 + hi_bits - 23) - 127 - hi_bits)
                   .double())
    xd = x.double().view(m, k // chunk_rows, chunk_rows)
    hi = torch.trunc(xd / q) * q
    lo = xd - hi
    return (hi.reshape(m, k).to(x.dtype), lo.reshape(m, k).to(x.dtype))


def split_x3(x, chunk_rows=tqm.CHUNK_ROWS, hi_bits=7):
    """``x`` split as the kernel splits it for e4m3 weights, ``x = x_hi +
    x_mid + x_lo`` exactly: x_hi as :func:`split_x`, x_mid the rest
    truncated toward zero to a multiple of ``2**(E - 2 hi_bits)`` (the same
    E), x_lo what remains, all in x's dtype."""
    hi, rest = split_x(x, chunk_rows, hi_bits)
    m, k = x.shape
    bits = x.view(torch.int16).to(torch.int32) & 0x7FFF
    top = bits.view(m, k // chunk_rows, chunk_rows).amax(-1, keepdim=True)
    e = (top >> 7) if x.dtype == torch.bfloat16 else (top >> 10) + 112
    q = torch.exp2((e.clamp(min=24 + 2 * hi_bits - 23) - 127 - 2 * hi_bits)
                   .double())
    rd = rest.double().view(m, k // chunk_rows, chunk_rows)
    mid = torch.trunc(rd / q) * q
    return (hi, mid.reshape(m, k).to(x.dtype),
            (rd - mid).reshape(m, k).to(x.dtype))


def split_w_bands(w_q):
    """An e4m3 weight split as the kernel widens it, ``w = w_0 + w_1 + w_2
    + w_3`` (f64): the weights whose exponent field (bits 3-6 of the byte)
    lies in 0-4, 5-8, 9-12 and 13-15, each 0 where the weight lies in
    another band.  Each band spans at most four binades: its weights are
    below 2**7 of its granularity, as an int8 weight is of 1."""
    f = (w_q.view(torch.uint8).to(torch.int32) >> 3) & 0xF
    w = w_q.double()
    return tuple(torch.where((f >= lo) & (f <= hi), w, 0.0)
                 for lo, hi in ((0, 4), (5, 8), (9, 12), (13, 15)))


def _add_partial(th, tl, hi, lo):
    """(th, tl) += (hi, lo) in f32, th the rounded sum th + hi and tl its
    exact rounding error plus lo (the kernel's add_partial)."""
    s = th + hi
    bp = s - th
    return s, (tl + ((th - (s - bp)) + (hi - bp))) + lo


def _f32_kernel_order(x2d, w_q, scale, chunk_rows=tqm.CHUNK_ROWS):
    """The CUDA-core kernel's order for f32 activations: per chunk of
    ``chunk_rows`` K rows, each output's partial is one chain of f32 FMAs
    over the chunk's rows in ascending order, from 0 (each step the exact
    product added in f64, rounded once to f32); the partials are added in
    chunk order into an f32 total from 0; times the scale, rounded."""
    m, k = x2d.shape
    xd, wd = x2d.double(), w_q.double()
    total = torch.zeros(m, w_q.shape[1], dtype=torch.float32)
    for c in range(0, k, chunk_rows):
        acc = torch.zeros_like(total)
        for r in range(c, c + chunk_rows):   # an FMA: one rounding a step
            acc = (acc.double() + xd[:, r, None] * wd[None, r]).float()
        total = total + acc
    return total * scale.float()


def quant_matmul_chunked(x2d, w_q, scale, chunk_rows=tqm.CHUNK_ROWS):
    """The tensor-core kernel's order of the sum in plain PyTorch: per
    chunk of ``chunk_rows`` K rows, x split by :func:`split_x` and the
    chunk's two partials ``f32(x_hi . w)`` and ``f32(x_lo . w)`` (each
    exact in f64, rounded once), added in chunk order into a total carried
    in two f32 (TwoSum), from 0; its sum times the scale, rounded to x's
    dtype.  e4m3 weights: x split three ways (:func:`split_x3`) and the
    weight into four bands (:func:`split_w_bands`); band by band the exact
    sums ``x_hi . w_b`` and ``x_mid . w_b`` are added by TwoSum into the
    chunk's pair, their rounding errors and then x_lo's partial into its
    low part.  Every sum but x_lo's is exact on the tensor cores, so this
    is the kernel's result up to the bits the tensor core drops from
    x_lo's sum, far below an ulp.  f32 activations: the CUDA-core kernel's
    order (:func:`_f32_kernel_order`)."""
    if x2d.dtype == torch.float32:
        return _f32_kernel_order(x2d, w_q, scale)
    m, k = x2d.shape
    w = w_q.double()
    fp8 = w_q.dtype == torch.float8_e4m3fn
    if fp8:
        hi, mid, lo = split_x3(x2d, chunk_rows)
        bands = split_w_bands(w_q)
    else:
        hi, lo = split_x(x2d, chunk_rows)
    th = torch.zeros(m, w_q.shape[1], dtype=torch.float32)
    tl = torch.zeros_like(th)
    zero = torch.zeros_like(th)
    for c in range(0, k, chunk_rows):
        rows = slice(c, c + chunk_rows)
        p_lo = (lo[:, rows].double() @ w[rows]).float()
        if not fp8:
            p_hi = (hi[:, rows].double() @ w[rows]).float()
            th, tl = _add_partial(th, tl, p_hi, p_lo)
            continue
        hc, lc = None, zero
        for band in bands:         # exact sums added by TwoSum, band order
            for part in (hi, mid):
                s = (part[:, rows].double() @ band[rows]).float()
                if hc is None:
                    hc = s
                else:
                    hc, e = _add_partial(hc, zero, s, zero)
                    lc = lc + e
        th, tl = _add_partial(th, tl, hc, lc + p_lo)
    return ((th + tl) * scale.float()).to(x2d.dtype)


PLAN_MS = (1, 8, 16, 17, 200, 256, 4096)
PLAN_KS = (128, 256, 640, 768, 3072, 4096, 8192)
PLAN_NS = (128, 384, 768, 2304, 3072, 8192)


@pytest.mark.parametrize("xdtype", [torch.bfloat16, torch.float16,
                                    torch.float32], ids=str)
def test_plan_order_depends_on_k_and_n_only(xdtype):
    """The chunks of K and their order are the same at every M: a row
    alone and the same row in a batch of 4096 are summed alike, whichever
    schedule (the decode split or the prefill walk) each M takes."""
    for k in PLAN_KS:
        for n in PLAN_NS:
            plans = [tqm.quant_plan(m, k, n, xdtype) for m in PLAN_MS]
            first = plans[0]
            assert first.chunk_rows * first.chunks == k
            assert first.order == tuple(range(k // first.chunk_rows))
            for m, p in zip(PLAN_MS, plans):
                assert (p.chunk_rows, p.chunks, p.order) == (
                    first.chunk_rows, first.chunks, first.order), (m, k, n)
                # the blocks of a tile cover its chunks once, in runs
                g = p.chunks_per_block
                assert 1 <= g <= p.chunks
                assert p.splits == -(-p.chunks // g)
                assert (p.splits - 1) * g < p.chunks <= p.splits * g
                assert p.n_tiles * (tqm.TILE_N if p.route == "tc" else 64) \
                    == n
                if p.split and p.route == "f32":   # tiles too few
                    warps = 4 if m <= 8 else 1
                    assert 2 * p.m_tiles * p.n_tiles * warps < 16 * 132
                    assert p.chunks * m * n * 4 <= (25 if m <= 8 else 40) \
                        * 2 ** 20
                elif p.split:     # tiles too few for the card
                    if m <= tqm.TILE_M:
                        assert p.chunks * m * n * 8 <= 25 * 2 ** 20
                    else:         # past one tile of x: a chunk a block
                        assert 4 * p.m_tiles * p.n_tiles <= 132
                        assert p.chunks * m * n * 8 <= 40 * 2 ** 20
                        assert g == 1
    # GPT-2-small at decode: every chunk its own block
    p = tqm.quant_plan(8, 768, 2304, torch.bfloat16)
    assert (p.splits, p.n_tiles * p.splits) == (6, 108)
    assert not tqm.quant_plan(256, 768, 2304, torch.bfloat16).split
    # its fc_out at M = 256 (4 x 6 tiles) splits a chunk a block; at M =
    # 1024 (96 tiles) it walks
    p = tqm.quant_plan(256, 3072, 768, torch.bfloat16)
    assert (p.splits, p.chunks_per_block, p.m_tiles * p.n_tiles) == (
        24, 1, 24)
    assert not tqm.quant_plan(1024, 3072, 768, torch.bfloat16).split


@pytest.mark.parametrize("k,n", [(768, 2304), (768, 768), (768, 3072),
                                 (3072, 768)], ids=lambda v: str(v))
def test_f32_plan_splits_at_decode_and_walks_past_it(k, n):
    """The f32 kernel's schedule at GPT-2-small's projections: at decode
    (M <= 8) one tile of x a column strip and every chunk its own block
    (the split: all of a projection's weight bytes in flight at once); at
    M = 1024 every tile walks its chunks (no scratch); at M = 256 the walk
    where the tiles fill the card (qkv, fc_in), else the split (out,
    fc_out: 384 tiles).  The chunks and their order are K's alone."""
    chunks = k // 128
    for m in (1, 8):
        p = tqm.quant_plan(m, k, n, torch.float32)
        assert (p.route, p.m_tiles, p.n_tiles) == ("f32", 1, n // 64)
        assert p.split and p.chunks_per_block == 1 and p.splits == chunks
    p = tqm.quant_plan(1024, k, n, torch.float32)
    assert not p.split and p.chunks_per_block == chunks
    assert p.m_tiles == 128
    p = tqm.quant_plan(256, k, n, torch.float32)
    assert p.split is (n == 768)
    for m in (1, 8, 17, 256, 1024):
        p = tqm.quant_plan(m, k, n, torch.float32)
        assert (p.chunk_rows, p.chunks, p.order) == (
            128, chunks, tuple(range(chunks)))


@pytest.mark.parametrize("wkind", ["int8", "fp8"])
def test_f32_rows_alone_equal_their_rows_in_a_batch(wkind):
    """The f32 order gives rows of M = 1 and 8 (decode: the split) the
    same bits as the same rows of M = 256, whichever schedule that takes:
    the order depends on K alone.  And its sum is within 1e-5 of max|ref|
    of the exact one (f64)."""
    x, w, s = _case(31, 256, 640, 384, wkind, "float32")
    tx, tw, ts = to_tensor(x), to_tensor(w), to_tensor(s)
    assert tqm.quant_plan(8, 640, 384, torch.float32).split
    assert not tqm.quant_plan(256, 640, 2304, torch.float32).split
    full = _f32_kernel_order(tx, tw, ts)
    for m in (1, 8):
        assert torch.equal(_f32_kernel_order(tx[:m], tw, ts), full[:m])
    exact = (tx.double() @ tw.double()) * ts.double()
    assert float((full.double() - exact).abs().max()) <= \
        1e-5 * float(exact.abs().max())


def _noise(x, w, s):
    """Each output's f32 accumulation noise, sqrt(K) 2**-24 sum_k |x w| s
    (the scale below which two orders of the same exact f32 products may
    differ, as chip_smoke.py floors its readings)."""
    x64, w64 = np.abs(_f32(x)).astype(np.float64), np.abs(_f32(w)).astype(
        np.float64)
    return (x64 @ w64) * s * (x.shape[1] ** 0.5 * 2.0 ** -24)


def bf16_ulps_floored(got, ref, floor):
    """bf16 ulps of ``ref``, each output's ulp taken at max(|ref|,
    floor)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    mag = np.maximum(np.abs(ref), floor)
    ulp = np.where(mag > 0, 2.0 ** (np.floor(np.log2(np.where(
        mag > 0, mag, 1.0))) - 7), 1e-6)
    return float((np.abs(got - ref) / ulp).max())


@pytest.mark.parametrize("xdtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("wkind", ["int8", "fp8"])
@pytest.mark.parametrize("k", [128, 640, 768, 3072])
def test_chunked_order_matches_jax(k, wkind, xdtype):
    """The kernel's order (bf16: x split exactly into high and low bits per
    128-row chunk, two f32 partials per chunk, added in chunk order into a
    two-float total, then the scale and one rounding; f32: the CUDA-core
    kernel's 32 slices of FMAs) against the JAX package's Pallas kernel
    under the interpreter and its jnp reference: bf16 within 1 bf16 ulp
    (floored at the f32 sum noise), f32 within 1e-5 of max|ref|."""
    x, w, s = _case(k + len(wkind), 17, k, 256, wkind, xdtype)
    got = _torch_f32(quant_matmul_chunked(to_tensor(x), to_tensor(w),
                                              to_tensor(s)))
    jx, jw, js = jnp.asarray(x), jnp.asarray(w), jnp.asarray(s)
    for ref in (_f32(_jax_kernel(jx, jw, js)),
                _f32(jqm.quant_matmul_ref(jx, jw, js))):
        if xdtype == "bfloat16":
            assert bf16_ulps_floored(got, ref, _noise(x, w, s)) <= 1
        else:
            assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    # and against the port's plain version, the same function
    plain = _torch_f32(tqm.quant_matmul_ref(to_tensor(x), to_tensor(w),
                                            to_tensor(s)))
    if xdtype == "bfloat16":
        assert bf16_ulps_floored(got, plain, _noise(x, w, s)) <= 1
    else:
        assert np.abs(got - plain).max() <= 1e-5 * np.abs(plain).max()


def _ulps_floored(got, ref, floor, bits):
    """Largest error of ``got`` in ulps (``bits`` below the leading bit: 7
    for bf16, 10 for f16) of ``ref``, each output's ulp taken at max(|ref|,
    floor), as chip_smoke.py reads K4."""
    got, ref = got.double(), ref.double()
    mag = torch.maximum(ref.abs(), floor.double())
    ulp = torch.where(mag > 0, torch.exp2(torch.floor(torch.log2(
        mag.clamp_min(1e-300))) - bits), torch.full_like(mag, 1e-6))
    return float(((got - ref).abs() / ulp).max())


@pytest.mark.parametrize("xdtype", [torch.bfloat16, torch.float16],
                         ids=str)
@pytest.mark.parametrize("wkind", ["int8", "fp8"])
@pytest.mark.parametrize("m,k,n", [(8, 768, 2304), (64, 768, 2304),
                                   (256, 768, 2304), (256, 3072, 768)],
                         ids=lambda v: str(v))
def test_chunked_order_within_an_ulp_of_the_exact_sum(m, k, n, wkind,
                                                      xdtype):
    """The kernel's order against the exact sum (f64, rounded once to f32,
    times the scale) at GPT-2-small's projections, the data of
    chip_smoke.py's K4 cases (N(0, 1) activations, N(0, 0.02) weights
    quantized by the port): within 1 ulp of the output type, bf16 or f16,
    floored at the f32 sum noise.  (An f32 sum in one pass reads up to 16
    f16 ulps there, the noise the f16 checks are held clear of.)"""
    from paddle_hackathon_tpu_torch.nn.quant import weight_only as wo
    rng = np.random.RandomState(m + k + n)
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(xdtype)
    w32 = torch.from_numpy((rng.randn(k, n) * 0.02).astype(np.float32))
    w_q, scale = wo.quantize_array(w32, wkind)
    exact = ((x.double() @ w_q.double()).float() * scale).to(xdtype)
    noise = (x.float().abs() @ w_q.float().abs()) * scale * (
        k ** 0.5 * 2.0 ** -24)
    got = quant_matmul_chunked(x, w_q, scale)
    bits = 7 if xdtype == torch.bfloat16 else 10
    assert _ulps_floored(got, exact, noise, bits) <= 1


@pytest.mark.parametrize("xdtype", [torch.bfloat16, torch.float16],
                         ids=str)
def test_split_x_exact(xdtype):
    """x = x_hi + x_lo exactly, both in x's dtype; x_hi a multiple of
    2**(E - 7) (E the exponent of its chunk row's largest magnitude) with
    |x_hi| <= |x|, so that x_hi times an int8 weight sums exactly in 24
    bits; x_lo below it, of x's sign.  Rows of mixed scales, zeros and an
    all-zero row."""
    rng = np.random.RandomState(11)
    x = rng.randn(6, 256) * np.exp2(rng.randint(-12, 6, (6, 256)))
    x[1, :128] = 0.0
    x[2, 5] = 0.0
    x[3] *= 1e-3
    xt = torch.from_numpy(x.astype(np.float32)).to(xdtype)
    hi, lo = split_x(xt)
    assert hi.dtype == lo.dtype == xdtype
    assert torch.equal(hi.double() + lo.double(), xt.double())
    for c in (0, 128):
        blk = xt[:, c:c + 128].double()
        top = blk.abs().amax(-1, keepdim=True)
        e = torch.floor(torch.log2(torch.where(top > 0, top,
                                               torch.ones_like(top))))
        q = torch.exp2(e - 7)
        h = hi[:, c:c + 128].double()
        assert torch.equal(torch.remainder(h, q), torch.zeros_like(h))
        lo_c = lo[:, c:c + 128].double()
        assert bool((lo_c.abs() < q).all())
        assert bool((lo_c * blk >= 0).all())
    assert torch.equal(hi[1, :128].double(), torch.zeros(128,
                                                          dtype=torch.float64))


def _exact_in_bits(parts, bits=22):
    """Whether every sum of ``parts`` (f64 products of one chunk row, last
    axis the chunk) is exact in ``bits`` bits, whatever the order or
    grouping of the tensor core's sum: each product a multiple of the
    smallest power-of-two granularity g of the nonzero ones, and the sum of
    their magnitudes below 2**bits g.  Per row.  22 bits is where int8's
    x_hi sums lie (8-bit x_hi times |w| <= 128, 128 rows): the kernel holds
    e4m3 to the same."""
    out = []
    for row in parts:
        nz = row[row != 0]
        if nz.numel() == 0:
            out.append(True)
            continue
        m, e = torch.frexp(nz)
        # the lowest set bit of each product (53-bit significands)
        sig = (m * 2.0 ** 53).to(torch.int64)
        low = (sig & -sig).double().log2() + e.double() - 53
        g = 2.0 ** float(low.min())
        out.append(bool((row.abs().sum() / g) < 2.0 ** bits))
    return out


@pytest.mark.parametrize("xdtype", [torch.bfloat16, torch.float16],
                         ids=str)
def test_split_e4m3_bands_exact(xdtype):
    """e4m3 weights over their whole range (2**-9 .. 448, subnormals and
    zeros, each value in a chunk's rows) times x split three ways (x_hi of
    7 bits as for int8, x_mid of the next 7, x_lo below 2**-14 of the
    row's largest): x_hi . w_b and x_mid . w_b are exact in 22 bits, where
    int8's sums lie, for each of the four bands, and w_0 + ... + w_3 = w.
    The earlier split (x_hi of 5 bits times the unsplit weight) fails a
    case built for it: 127 weights of 448 and one of 2**-9 in one chunk,
    the running sum past 24 bits; and the whole range unsplit spans more
    than 24 bits."""
    rng = np.random.RandomState(17)
    vals = _all_weights(torch.float8_e4m3fn)
    w = torch.cat([vals, vals[:2]]).view(torch.uint8)[
        torch.from_numpy(rng.permutation(256))].view(torch.float8_e4m3fn)
    bands = split_w_bands(w)
    assert torch.equal(sum(bands), w.double())
    # the band edges: below 2**-2, [2**-2, 2**2), [2**2, 2**6), [2**6, 448]
    edges = (0.0, 0.25, 4.0, 64.0, 512.0)
    for band, lo_e, hi_e in zip(bands, edges, edges[1:]):
        live = band[band != 0].abs()
        assert float(live.min()) >= lo_e and float(live.max()) < hi_e
    # rows of mixed scales; row 0 holds the largest x_hi (255 q) in both
    # chunks
    x = rng.randn(8, 256) * np.exp2(rng.randint(-10, 4, (8, 256)))
    x[0, :] = 1.9921875
    x[1, 3] = 0.0
    xt = torch.from_numpy(x.astype(np.float32)).to(xdtype)
    hi, mid, lo = split_x3(xt)
    assert hi.dtype == mid.dtype == lo.dtype == xdtype
    assert torch.equal(hi.double() + mid.double() + lo.double(),
                       xt.double())
    assert torch.equal(hi, split_x(xt)[0])
    for c in (0, 128):
        blk = xt[:, c:c + 128].double()
        top = blk.abs().amax(-1, keepdim=True)
        e = torch.floor(torch.log2(torch.where(top > 0, top,
                                               torch.ones_like(top))))
        q14 = torch.exp2(e - 14)
        m_c, l_c = mid[:, c:c + 128].double(), lo[:, c:c + 128].double()
        assert torch.equal(torch.remainder(m_c, q14), torch.zeros_like(m_c))
        assert bool((m_c.abs() < torch.exp2(e - 7)).all())
        assert bool((l_c.abs() < q14).all())
        for part in (hi, mid):
            h = part[:, c:c + 128].double()
            for band in bands:
                assert all(_exact_in_bits(h * band[c:c + 128][None, :]))
        # the whole range spans more than 24 bits unsplit
        assert not all(_exact_in_bits(h * w[c:c + 128].double()[None], 24))
    # the case built for the old split: its running sum is not an f32
    xo = torch.full((1, 128), 1.96875, dtype=xdtype)
    wo = torch.full((128,), 448.0).to(torch.float8_e4m3fn)
    wo[127] = 2.0 ** -9
    ho, _ = split_x(xo, hi_bits=5)
    prods = ho.double()[0] * wo.double()
    run = torch.cumsum(prods, 0)
    assert not torch.equal(run.float().double(), run)
    assert not _exact_in_bits(prods[None], 24)[0]
    h7, _ = split_x(xo)
    for band in split_w_bands(wo):
        run = torch.cumsum(h7.double()[0] * band, 0)
        assert torch.equal(run.float().double(), run)
        assert _exact_in_bits((h7.double()[0] * band)[None])[0]


def _all_weights(wdtype):
    """Every int8 value, or every finite e4m3 value (0x7F and 0xFF are its
    NaNs)."""
    b = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    if wdtype == torch.float8_e4m3fn:
        b = b[(b & 0x7F) != 0x7F]
    return b.view(wdtype)


@pytest.mark.parametrize("to", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("wdtype", [torch.int8, torch.float8_e4m3fn],
                         ids=str)
def test_widen_bits_exact(wdtype, to):
    """The kernel's bit-trick widening gives every weight value exactly,
    signed zeros and e4m3 subnormals included."""
    w = _all_weights(wdtype)
    assert w.numel() == (256 if wdtype == torch.int8 else 254)
    got = widen_bits(w, to)
    want = w.to(to)
    assert got.dtype == to
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert torch.equal(got.float(), w.float())


@pytest.mark.parametrize("xdtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("m", [1, 524_289])
def test_geometry_takes_k640_n384(m, xdtype):
    """K = 640 (5 chunks, not a power of two) with N = 384, one row or
    524,289 rows: the geometry check takes it, and both plans sum the same
    chunks in the same order."""
    plan = tqm.check_geometry(m, 640, 384, xdtype, torch.int8)
    assert plan == tqm.check_geometry(m, 640, 384, xdtype,
                                      torch.float8_e4m3fn)
    assert plan.chunks == 5 and plan.order == (0, 1, 2, 3, 4)
    assert plan.order == tqm.quant_plan(1, 640, 384, xdtype).order
    tile_m = tqm.TILE_M if xdtype != torch.float32 else 8
    assert plan.m_tiles == -(-m // tile_m)
    with pytest.raises(ValueError, match="lane-aligned"):
        tqm.check_geometry(m, 640, 320, xdtype, torch.int8)
    with pytest.raises(ValueError, match="at least 1"):
        tqm.check_geometry(0, 640, 384, xdtype, torch.int8)


def test_dispatcher_hands_the_kernel_a_contiguous_weight_and_f32_scale():
    """A transposed weight view and a bf16 scale (the JAX package casts the
    scale to f32) reach the kernel as a contiguous weight and an f32
    scale (``kernel_weight_args``), whose own checks stay strict; on the
    CPU the dispatch gives the same result."""
    x, w, s = _case(7, 4, 128, 256, "int8", "bfloat16")
    wt = to_tensor(np.ascontiguousarray(w.T)).T
    scale = to_tensor(s).to(torch.bfloat16)
    assert not wt.is_contiguous()
    w_k, s_k = tqm.kernel_weight_args(wt, scale)
    assert w_k.is_contiguous() and torch.equal(w_k, to_tensor(w))
    assert s_k.dtype == torch.float32 and torch.equal(s_k, scale.float())
    # what WeightOnlyLinear holds passes through as the same tensors
    again = tqm.kernel_weight_args(w_k, s_k)
    assert again[0] is w_k and again[1] is s_k
    x2d = to_tensor(x)
    tqm.check_kernel_args(x2d, w_k, s_k)
    with pytest.raises(ValueError, match="float32"):
        tqm.check_kernel_args(x2d, w_k, scale)
    with pytest.raises(ValueError, match="contiguous"):
        tqm.check_kernel_args(x2d, wt, s_k)
    np.testing.assert_array_equal(
        _torch_f32(tqm.quant_matmul(x2d, wt, scale)),
        _torch_f32(tqm.quant_matmul(x2d, w_k, s_k)))
