"""The port's tape over torch autograd (``core/autograd.py``,
``core/tensor.py``, ``autograd/``) against the JAX package's engine:
every case of ``tests/test_autograd.py`` but its six
``test_dispatch_cache_*`` cases (the JAX jit dispatch cache has no
counterpart: torch's eager dispatch takes its place) runs through both
packages, and the values and gradients are compared at f32 rtol 1e-5 /
atol 1e-6.  ``PyLayer`` is held against the JAX package's ``PyLayer``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import paddle_hackathon_tpu as jp
import paddle_hackathon_tpu_torch as tp
from paddle_hackathon_tpu import nn as jnn
from paddle_hackathon_tpu_torch import nn as tnn

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")
    yield


def _np(t):
    return np.asarray(t._value) if isinstance(t, jp.Tensor) else t.numpy()


def _both(case):
    """``case(pkg)`` returns a dict of tensors / arrays / python values;
    the two packages' dicts must agree."""
    got = {p: case(p) for p in (jp, tp)}
    j, t = got[jp], got[tp]
    assert list(j) == list(t)
    for k in j:
        a, b = j[k], t[k]
        if isinstance(a, (jp.Tensor, tp.Tensor)) or a is None:
            assert (a is None) == (b is None), k
            if a is None:
                continue
            a, b = _np(a), _np(b)
        if isinstance(a, np.ndarray):
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL,
                                       err_msg=k)
        else:
            assert a == b, (k, a, b)
    return t


def test_simple_chain():
    def case(p):
        x = p.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
        (x * 2 + 1).sum().backward()
        return {"grad": x.grad}
    _both(case)


def test_matmul_grad_matches_jax():
    rng = np.random.RandomState(0)
    a = rng.randn(4, 3).astype("float32")
    b = rng.randn(3, 5).astype("float32")

    def case(p):
        x = p.to_tensor(a, stop_gradient=False)
        w = p.to_tensor(b, stop_gradient=False)
        loss = p.tanh(p.matmul(x, w)).mean()
        loss.backward()
        return {"loss": loss, "gx": x.grad, "gw": w.grad}
    t = _both(case)
    ga, gb = jax.grad(lambda p, q: jnp.mean(jnp.tanh(p @ q)),
                      argnums=(0, 1))(a, b)
    np.testing.assert_allclose(t["gx"].numpy(), ga, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t["gw"].numpy(), gb, rtol=RTOL, atol=ATOL)


def test_diamond_accumulation():
    def case(p):
        a = p.to_tensor([2.0], stop_gradient=False)
        b = a * a
        (b + 3 * b).backward()
        return {"grad": a.grad}
    _both(case)


def test_grad_accumulates_across_backwards():
    def case(p):
        x = p.to_tensor([1.0], stop_gradient=False)
        (x * 2).backward()
        (x * 3).backward()
        g = x.grad
        x.clear_grad()
        return {"grad": g, "cleared": x.grad is None}
    _both(case)


def test_retain_graph():
    def case(p):
        x = p.to_tensor([1.0], stop_gradient=False)
        y = x * x
        y.backward(retain_graph=True)
        y.backward()
        return {"grad": x.grad}
    _both(case)


def test_released_graph_raises():
    for p in (jp, tp):
        x = p.to_tensor([1.0], stop_gradient=False)
        y = x * x
        y.backward()
        with pytest.raises(RuntimeError):
            y.backward()


def test_no_grad():
    def case(p):
        x = p.to_tensor([1.0], stop_gradient=False)
        with p.no_grad():
            y = x * 2
        return {"sg": y.stop_gradient, "node": y._grad_node is None}
    _both(case)


def test_stop_gradient_cuts_graph():
    def case(p):
        x = p.to_tensor([1.0], stop_gradient=False)
        z = (x * 2).detach() * 3
        return {"sg": z.stop_gradient}
    _both(case)


def test_paddle_grad_api():
    def case(p):
        x = p.to_tensor([1.0, 2.0], stop_gradient=False)
        (g,) = p.grad((x ** 3).sum(), [x])
        return {"g": g, "untouched": x.grad is None}
    _both(case)


def test_grad_allow_unused():
    def case(p):
        x = p.to_tensor([1.0], stop_gradient=False)
        z = p.to_tensor([1.0], stop_gradient=False)
        with pytest.raises(ValueError):
            p.grad(x * 2, [z])
        (g,) = p.grad(x * 2, [z], allow_unused=True)
        return {"g": g}
    _both(case)


def test_leaf_hook_modifies_grad():
    def case(p):
        x = p.to_tensor([1.0], stop_gradient=False)
        x.register_hook(lambda g: g * 10)
        (x * 2).backward()
        return {"grad": x.grad}
    _both(case)


def test_intermediate_hook_observes_grad():
    def case(p):
        seen = []
        x = p.to_tensor([1.0], stop_gradient=False)
        mid = x * 2
        h = mid.register_hook(lambda g: seen.append(_np(g)))
        (mid * 3).backward()
        h.remove()
        return {"seen": seen[0], "grad": x.grad}
    _both(case)


def test_multi_output_op_grads():
    def case(p):
        x = p.to_tensor(np.arange(6, dtype="float32").reshape(2, 3),
                        stop_gradient=False)
        a, b = p.split(x, 2, axis=0)
        (a.sum() * 2 + b.sum() * 3).backward()
        return {"grad": x.grad}
    _both(case)


def test_backward_with_grad_tensor():
    def case(p):
        x = p.to_tensor([1.0, 2.0], stop_gradient=False)
        (x * 3).backward(p.to_tensor([1.0, 10.0]))
        return {"grad": x.grad}
    _both(case)


def test_int_tensors_not_differentiable():
    def case(p):
        x = p.to_tensor([1, 2, 3], stop_gradient=False)
        y = x + 1
        return {"node": y._grad_node is None, "dtype": str(y.dtype),
                "x_sg": x.stop_gradient}
    _both(case)


def test_setitem_on_tape():
    def case(p):
        x = p.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
        y = x * 2
        y[1] = 0.0
        y.sum().backward()
        return {"y": y, "grad": x.grad}
    _both(case)


def test_nan_check_flag():
    for p in (jp, tp):
        p.set_flags({"check_nan_inf": True})
        try:
            with pytest.raises(FloatingPointError):
                p.log(p.to_tensor([-1.0]))
        finally:
            p.set_flags({"check_nan_inf": False})
        assert p.get_flags("FLAGS_check_nan_inf") == {
            "FLAGS_check_nan_inf": False}


def test_grad_on_intermediate_tensor():
    def case(p):
        x = p.to_tensor([3.0], stop_gradient=False)
        y = x * 2
        (gy,) = p.grad((y * y).sum(), [y])
        return {"gy": gy}
    _both(case)


def test_double_grad_scalar():
    def case(p):
        x = p.to_tensor([2.0, -1.5], stop_gradient=False)
        (g,) = p.grad((x * x * x).sum(), [x], create_graph=True)
        (g2,) = p.grad(g.sum(), [x])
        return {"g": g, "g2": g2, "g_sg": g.stop_gradient}
    _both(case)


def test_double_grad_matches_jax_composition():
    """Gradient penalty: d/dW of ||d out/d x||^2 on a small MLP, the port's
    Linear layers holding the JAX package's weights."""
    jp.seed(0)
    jl1, jl2 = jnn.Linear(4, 8), jnn.Linear(8, 1)
    tl1, tl2 = tnn.Linear(4, 8), tnn.Linear(8, 1)
    for jl, tl in ((jl1, tl1), (jl2, tl2)):
        tl.set_state_dict({k: np.asarray(v._value)
                           for k, v in jl.state_dict().items()})
    xin = np.random.RandomState(0).randn(3, 4).astype("float32")
    grads = {}
    for p, l1, l2 in ((jp, jl1, jl2), (tp, tl1, tl2)):
        x = p.to_tensor(xin, stop_gradient=False)
        out = l2(p.tanh(l1(x))).sum()
        (gx,) = p.grad(out, [x], create_graph=True)
        (gx * gx).sum().backward()
        grads[p] = [l1.weight, l2.weight, l1.bias]
    for j, t in zip(grads[jp], grads[tp]):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j._grad_value),
                                   rtol=RTOL, atol=ATOL)


def test_double_grad_third_order():
    def case(p):
        x = p.to_tensor([1.5], stop_gradient=False)
        (g1,) = p.grad((x ** 4).sum(), [x], create_graph=True)
        (g2,) = p.grad(g1.sum(), [x], create_graph=True)
        (g3,) = p.grad(g2.sum(), [x])
        return {"g1": g1, "g2": g2, "g3": g3}
    _both(case)


def test_double_grad_allow_unused():
    def case(p):
        x = p.to_tensor([1.0], stop_gradient=False)
        z = p.to_tensor([1.0], stop_gradient=False)
        (g,) = p.grad((x * x).sum(), [x], create_graph=True)
        gx, gz = p.grad(g.sum(), [x, z], allow_unused=True)
        return {"gx": gx, "gz": gz}
    _both(case)


def test_grad_on_leaf_output_does_not_pollute():
    def case(p):
        x = p.to_tensor([1.0, 2.0], stop_gradient=False)
        (g1,) = p.grad(x, [x])
        (g2,) = p.grad(x, [x])
        return {"g1": g1, "g2": g2, "untouched": x.grad is None}
    _both(case)


def test_double_grad_uses_recorded_values_after_inplace_update():
    """An in-place update between the forward and the second grad does not
    change the recorded values: d2/dx2 x^3 = 6x at the recorded x = 2."""
    def case(p):
        x = p.to_tensor([2.0], stop_gradient=False)
        (g1,) = p.grad((x * x * x).sum(), [x], create_graph=True)
        x.set_value(np.asarray([100.0], np.float32))
        (g2,) = p.grad(g1.sum(), [x])
        return {"g2": g2, "x": x}
    t = _both(case)
    np.testing.assert_allclose(t["g2"].numpy(), [12.0], rtol=1e-6)


def test_no_grad_vars_and_grad_mode_switches():
    """``paddle.grad``'s ``no_grad_vars`` stops the gradient through a
    tensor; ``set_grad_enabled`` / ``enable_grad`` / ``is_grad_enabled``
    are torch's switches."""
    x = tp.to_tensor([2.0], stop_gradient=False)
    y = x * 3
    z = y * x
    (g,) = tp.grad(z.sum(), [x], no_grad_vars=[y])
    np.testing.assert_allclose(g.numpy(), [6.0])   # only z's direct x
    with tp.set_grad_enabled(False):
        assert not tp.is_grad_enabled()
        with tp.enable_grad():
            assert tp.is_grad_enabled()
    assert tp.is_grad_enabled()


# -- PyLayer ----------------------------------------------------------------
def _cube_layer(p):
    class Cube(p.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, scale=2.0):
            ctx.save_for_backward(x)
            ctx.scale = scale
            return x * x * x * scale

        @staticmethod
        def backward(ctx, dy):
            (x,) = ctx.saved_tensor()
            return dy * 3 * x * x * ctx.scale
    return Cube


def _split_layer(p):
    class TwoOut(p.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, idx):
            ctx.save_for_backward(x)
            count = (x > 0).astype("float32")
            ctx.mark_non_differentiable(count)
            return x * 2.0, count

        @staticmethod
        def backward(ctx, dy, dcount):
            (x,) = ctx.saved_tensor()
            return dy * 2.0, None
    return TwoOut


def test_pylayer_matches_jax():
    xin = np.array([0.5, -1.5, 2.0], np.float32)

    def case(p):
        x = p.to_tensor(xin, stop_gradient=False)
        y = _cube_layer(p).apply(x, scale=0.5)
        (y * p.to_tensor([1.0, 2.0, 3.0])).sum().backward()
        out = {"y": y, "gx": x.grad, "sg": y.stop_gradient}
        x2 = p.to_tensor(xin, stop_gradient=False)
        idx = p.to_tensor([0, 1])
        a, cnt = _split_layer(p).apply(x2, idx)
        (a * a).sum().backward()
        out.update({"a": a, "cnt": cnt, "gx2": x2.grad})
        with p.no_grad():
            z = _cube_layer(p).apply(p.to_tensor(xin, stop_gradient=False))
        out["no_grad_sg"] = z.stop_gradient
        return out
    _both(case)
    # a PyLayer inside paddle.grad, through the backward entry point
    x = tp.to_tensor(xin, stop_gradient=False)
    (g,) = tp.grad(_cube_layer(tp).apply(x).sum(), [x])
    np.testing.assert_allclose(g.numpy(), 6 * xin * xin, rtol=RTOL)
    x.clear_grad()
    tp.autograd.backward([_cube_layer(tp).apply(x)],
                         [tp.to_tensor(np.ones(3, np.float32))])
    np.testing.assert_allclose(x.grad.numpy(), 6 * xin * xin, rtol=RTOL)


def test_pylayer_materialize_grads():
    """With ``set_materialize_grads(False)`` an unused output's gradient
    reaches backward as None, else as zeros."""
    seen = []

    def layer(materialize):
        class Two(tp.autograd.PyLayer):
            @staticmethod
            def forward(ctx, x):
                ctx.set_materialize_grads(materialize)
                return x * 1.0, x * 2.0

            @staticmethod
            def backward(ctx, da, db):
                seen.append(db)
                return da + (0 if db is None else db * 2.0)
        return Two

    for materialize in (True, False):
        x = tp.to_tensor([1.0, 2.0], stop_gradient=False)
        a, _ = layer(materialize).apply(x)
        a.sum().backward()
        np.testing.assert_allclose(x.grad.numpy(), [1.0, 1.0])
    assert seen[0] is not None and float(seen[0].sum()) == 0.0
    assert seen[1] is None
