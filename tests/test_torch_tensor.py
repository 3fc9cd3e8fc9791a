"""The port's ``Tensor`` and ``to_tensor`` (``core/tensor.py``) against the
JAX package's: every case of ``tests/test_tensor.py`` (but the
``StringTensor`` ones) runs through both packages, and what each case
observes (shapes, dtype names, values, stop_gradient, grads) is compared.
Values are f32 at rtol 1e-5 / atol 1e-6.

Also: ``to_tensor`` with no place raises without a card unless
``set_device("cpu")`` was called (the default place is the card, never
the CPU); and the dtype rule (integers int32, float64 numpy input
float32) and bf16 ``numpy()`` as ``uint16`` bits.
"""

import numpy as np
import pytest
import torch

import paddle_hackathon_tpu as jp
import paddle_hackathon_tpu_torch as tp
from paddle_hackathon_tpu_torch.core import device as tdevice

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")
    yield


def _np(t):
    return np.asarray(t._value) if isinstance(t, jp.Tensor) else t.numpy()


def _both(case):
    """Run ``case(pkg)`` in both packages; compare the observations."""
    got = {pkg: case(pkg) for pkg in (jp, tp)}
    j, t = got[jp], got[tp]
    assert list(j) == list(t)
    for k in j:
        a, b = j[k], t[k]
        if isinstance(a, (jp.Tensor, tp.Tensor)):
            a, b = _np(a), _np(b)
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
        else:
            assert a == b, (k, a, b)
    return t


def test_to_tensor_basics():
    def case(p):
        t = p.to_tensor([[1.0, 2.0], [3.0, 4.0]])
        return {"shape": t.shape, "ndim": t.ndim, "size": t.size,
                "dtype": str(t.dtype), "values": t.numpy()}
    t = _both(case)
    assert t["shape"] == [2, 2] and t["dtype"] == "float32"


def test_float64_numpy_downcast():
    _both(lambda p: {"dtype": str(p.to_tensor(np.zeros((2,))).dtype)})


def test_dtype_conversions():
    def case(p):
        t = p.to_tensor([1, 2, 3])
        return {"int": str(t.dtype), "arange": str(p.arange(5).dtype),
                "np_int": str(p.to_tensor(np.arange(3)).dtype),
                "argmax": str(t.argmax().dtype),
                "f": str(t.astype("float32").dtype),
                "i": str(t.astype(p.int32).dtype)}
    t = _both(case)
    assert t["int"] == t["arange"] == t["np_int"] == t["argmax"] == "int32"


def test_operators():
    def case(p):
        a = p.to_tensor([4.0, 9.0])
        b = p.to_tensor([2.0, 3.0])
        return {"add": a + b, "sub": a - b, "mul": a * b, "div": a / b,
                "pow": a ** 0.5, "matmul": a @ b, "neg": -a,
                "rsub": 1 - b, "rdiv": 10 / b,
                "gt": (a > b).numpy(), "eq": (a == a).numpy(),
                "mod": a % b, "floordiv": a // b, "rpow": 2 ** b,
                "abs": abs(-a)}
    _both(case)


def test_item_and_scalars():
    _both(lambda p: {"item": p.to_tensor(3.5).item(),
                     "float": float(p.to_tensor(3.5)),
                     "int": int(p.to_tensor(7)),
                     "bool": bool(p.to_tensor(True))})


def test_getitem_setitem():
    def case(p):
        t = p.to_tensor(np.arange(12, dtype="float32").reshape(3, 4))
        out = {"row": t[1], "slice": t[0:2, 1]}
        t[0] = 0.0
        out["set"] = t[0]
        out["idx"] = t[p.to_tensor([0, 2])]
        return out
    _both(case)


def test_detach_clone():
    def case(p):
        t = p.to_tensor([1.0], stop_gradient=False)
        d = t.detach()
        c = t.clone()
        sg = (d.stop_gradient, c.stop_gradient)
        c.backward()
        return {"sg": sg, "grad": t.grad}
    _both(case)


def test_fill_zero_inplace():
    def case(p):
        t = p.to_tensor([1.0, 2.0])
        t.fill_(7.0)
        f = t.numpy().copy()
        t.zero_()
        return {"fill": f, "zero": t.numpy()}
    _both(case)


def test_set_value():
    def case(p):
        t = p.to_tensor([1.0, 2.0])
        t.set_value(np.array([5.0, 6.0]))
        return {"v": t, "dtype": str(t.dtype)}
    _both(case)


def test_tensor_method_patching():
    def case(p):
        t = p.to_tensor([[1.0, 2.0], [3.0, 4.0]])
        return {"sum": t.sum().item(), "mean": t.mean().item(),
                "reshape": t.reshape([4]).shape,
                "transpose": t.transpose([1, 0]).shape,
                "exp": t.exp().shape, "max": t.max().item(),
                "argmax": t.argmax().item(), "t": t.t()}
    _both(case)


def test_len_iter_shape0():
    def case(p):
        t = p.to_tensor(np.zeros((5, 2), "float32"))
        with pytest.raises(TypeError):
            len(p.to_tensor(1.0))
        return {"len": len(t)}
    _both(case)


def test_repr_smoke():
    assert "Tensor(" in repr(tp.to_tensor([1.0]))
    assert "Tensor(" in repr(jp.to_tensor([1.0]))


def test_seed_reproducible():
    """Each package repeats its own draws from one seed (torch cannot
    reproduce JAX's draws)."""
    for p in (jp, tp):
        p.seed(42)
        a = p.randn([3])
        p.seed(42)
        b = p.randn([3])
        np.testing.assert_allclose(_np(a), _np(b))
        assert str(a.dtype) == "float32" and a.shape == [3]


def test_device_api():
    def case(p):
        place = p.set_device("cpu")
        return {"count": p.device_count("cpu") >= 1,
                "cpu": place.is_cpu_place(),
                "get": p.get_device().startswith("cpu")}
    _both(case)


def test_tensor_iteration_yields_rows_and_terminates():
    def case(p):
        t = p.to_tensor(np.arange(6, dtype="float32").reshape(3, 2))
        rows = [_np(r) for r in t]
        with pytest.raises(TypeError):
            iter(p.to_tensor(np.float32(1.0)))
        return {"n": len(rows), "last": rows[2]}
    _both(case)


def test_to_tensor_without_place_needs_a_card(monkeypatch):
    """The default place is the card: with no ``set_device`` and no card,
    ``to_tensor`` (and a creation op) raise; ``set_device("cpu")`` or an
    explicit ``place`` make them work."""
    monkeypatch.setattr(tdevice, "_current", None)
    assert tp.get_device() == "gpu:0"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tp.to_tensor([1.0])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tp.zeros([2])
    assert tp.to_tensor([1.0], place="cpu").place.is_cpu_place()
    tp.set_device("cpu")
    assert tp.to_tensor([1.0]).place == tp.Place("cpu")


def test_bf16_numpy_is_uint16_bits():
    """``numpy()`` of bf16 is the uint16 bit view (Paddle 2.3's answer), and
    ``to_tensor(bits, dtype="bfloat16")`` reads it back; widened to f32
    it equals the JAX package's bf16 values."""
    x = np.array([1.5, -2.25, 3.0e-3], np.float32)
    t = tp.to_tensor(x, dtype="bfloat16")
    bits = t.numpy()
    assert bits.dtype == np.uint16
    back = tp.to_tensor(bits, dtype="bfloat16")
    assert str(back.dtype) == "bfloat16"
    np.testing.assert_array_equal(back.astype("float32").numpy(),
                                  t.astype("float32").numpy())
    j = jp.to_tensor(x, dtype="bfloat16")
    np.testing.assert_array_equal(t.astype("float32").numpy(),
                                  np.asarray(j._value).astype(np.float32))
