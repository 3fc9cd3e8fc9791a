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
