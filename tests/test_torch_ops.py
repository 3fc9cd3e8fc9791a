"""The port's op table (``paddle_hackathon_tpu_torch/ops/``) against the
JAX package's, op by op, on the CPU.

- ``OP_TABLE`` has exactly the JAX package's 296 names, and every name
  has a case in ``test_torch_op_cases.py``.
- One parametrised case per op (the creation, math, search and random
  ops and ``diagonal`` here; the manipulation and in-place ops in
  ``test_torch_ops_shape.py``, linalg in ``test_torch_ops_linalg.py``):
  the same seeded numpy inputs go through
  both packages' op; the outputs agree in shape, dtype and value, and
  for differentiable float ops the gradients of a seeded weighted sum of
  the outputs agree too.  f32 at rtol 1e-5 / atol 1e-6 unless a case
  states a looser bound and why.  Random ops are held by shape, dtype,
  range and moments (torch cannot reproduce JAX's draws), and by
  ``seed`` giving the same draws twice.
- The method patching: every method of the JAX package's list that its
  ``Tensor`` has is on the port's ``Tensor``.

The JAX package runs eagerly (its ops are plain jnp compositions, no
Pallas).
"""

import numpy as np
import pytest

import paddle_hackathon_tpu as jp
import paddle_hackathon_tpu_torch as tp
from paddle_hackathon_tpu import ops as jops
from paddle_hackathon_tpu_torch import ops as tops
from test_torch_op_cases import (ALL, EXTRA, FIRST, RANDOM, SECOND, Side,
                                 _leaves, _make, _np, run_case)

JAX_SIDE = Side(jp, jops.OP_TABLE)
PORT_SIDE = Side(tp, tops.OP_TABLE, "cpu")


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")
    yield


def test_op_table_names_match():
    assert len(jops.OP_TABLE) == 296
    assert sorted(tops.OP_TABLE) == sorted(jops.OP_TABLE)


def test_cases_cover_op_table():
    assert sorted(ALL) == sorted(tops.OP_TABLE)
    assert not set(FIRST) & set(SECOND)


def _same_draws(name, case):
    """``seed`` repeats a port draw."""
    rng = np.random.RandomState(0)
    args = [_make(rng, s) for s in case.args]
    draws = []
    for _ in range(2):
        tp.seed(7)
        out = tops.OP_TABLE[name](*[tp.to_tensor(a) if isinstance(
            a, np.ndarray) else a for a in args], **case.kw)
        draws.append(_np(_leaves(out)[0]))
    np.testing.assert_array_equal(draws[0], draws[1])


@pytest.mark.parametrize("name", sorted(FIRST))
def test_op_matches_jax(name):
    run_case(name, FIRST[name], JAX_SIDE, PORT_SIDE)
    if name in EXTRA:
        run_case(name, EXTRA[name], JAX_SIDE, PORT_SIDE)
    if name in RANDOM:
        _same_draws(name, RANDOM[name])


def test_method_patching():
    """Every method of the JAX package's patch list that its Tensor has is
    on the port's Tensor, and calls the same op."""
    jt = jp.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
    names = [m for m in tops.TENSOR_METHODS if hasattr(jp.Tensor, m)]
    assert len(names) == len(tops.TENSOR_METHODS)
    for m in names + ["diagonal", "add_", "reshape_", "cond", "tolist"]:
        assert hasattr(tp.Tensor, m), m
    tt = tp.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
    for m, args in (("sum", ()), ("max", (1,)), ("transpose", ([1, 0],)),
                    ("cumsum", (1,)), ("reshape", ([3, 2],))):
        np.testing.assert_allclose(getattr(tt, m)(*args).numpy(),
                                   np.asarray(getattr(jt, m)(*args)._value))
