"""The port's linalg ops against the JAX package's, op by op, through
the harness of ``test_torch_op_cases.py``: values and gradients of a
seeded weighted sum at f32 rtol 1e-5 / atol 1e-6 unless a case states a
looser bound and why (a factorisation underneath rounds its sums in
another order).  Decompositions (``qr``, ``svd``, ``eig*``, ``lu``) are
held by invariants (reconstruction, orthogonality, the spectrum), not
by the sign of each vector.
"""

import pytest

import paddle_hackathon_tpu_torch as tp
from test_torch_op_cases import EXTRA, LINALG, run_case
from test_torch_ops import JAX_SIDE, PORT_SIDE


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")
    yield


@pytest.mark.parametrize("name", sorted(LINALG))
def test_op_matches_jax(name):
    run_case(name, LINALG[name], JAX_SIDE, PORT_SIDE)
    if name in EXTRA:
        run_case(name, EXTRA[name], JAX_SIDE, PORT_SIDE)
