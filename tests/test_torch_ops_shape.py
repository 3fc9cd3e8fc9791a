"""The port's manipulation and in-place ops against the JAX package's,
op by op, through the harness of ``test_torch_op_cases.py`` (the
same inputs, shapes, dtypes, values, gradients of a seeded weighted sum;
f32 at rtol 1e-5 / atol 1e-6 unless a case says why not).

Ops whose meaning differs between Paddle and torch are held to the JAX
package's: ``split(num_or_sections)`` with -1, ``gather`` as an
index-select, ``scatter`` overwriting or summing, ``unique``'s tuple,
``expand`` with -1, ``flatten(start_axis, stop_axis)``, ``where`` with
one argument, ``masked_select``, ``repeat_interleave``, negative-stride
``strided_slice``.  Each in-place ``<op>_`` runs on a recorded
tensor (``y = x * 1``), and both its value and the gradient reaching
``x`` through the rebind are compared.
"""

import numpy as np
import pytest

import paddle_hackathon_tpu as jp
import paddle_hackathon_tpu_torch as tp
from test_torch_op_cases import EXTRA, INPLACE, MANIPULATION, _np, run_case
from test_torch_ops import JAX_SIDE, PORT_SIDE


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")
    yield


SHAPE_OPS = dict(MANIPULATION, **INPLACE)


@pytest.mark.parametrize("name", sorted(SHAPE_OPS))
def test_op_matches_jax(name):
    run_case(name, SHAPE_OPS[name], JAX_SIDE, PORT_SIDE)
    if name in EXTRA:
        run_case(name, EXTRA[name], JAX_SIDE, PORT_SIDE)


def test_inplace_rebind_keeps_recorded_values():
    """An in-place op after the forward does not change what the graph
    recorded (the rebind leaves the old payload to the graph), in both
    packages."""
    for pkg in (jp, tp):
        x = pkg.to_tensor(np.array([1.0, 2.0], np.float32),
                          stop_gradient=False)
        y = x * 3.0
        z = (y * y).sum()
        y.add_(pkg.to_tensor(np.array([10.0, 10.0], np.float32)))
        z.backward()
        np.testing.assert_allclose(_np(x.grad), [18.0, 36.0])
        np.testing.assert_allclose(_np(y), [13.0, 16.0])


def test_inplace_on_leaf_parameter_copies():
    """Given a ``Parameter`` (a torch tensor), an in-place op copies the
    result into it without recording."""
    p = tp.create_parameter([3], default_initializer=tp.nn.initializer
                            .Constant(1.0), device="cpu")
    out = tp.ops.add_(p, 2.0)
    assert out is p
    np.testing.assert_allclose(p.numpy(), [3.0, 3.0, 3.0])
    assert p.grad_fn is None and p.requires_grad
