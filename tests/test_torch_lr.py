"""The port's LR schedulers (``paddle_hackathon_tpu_torch/optimizer/lr.py``)
against the JAX package's: each of the 15 schedulers over 30 steps gives
the same floats, its ``state_dict`` matches and round-trips, and an
optimizer reads a scheduler as its learning rate."""

import numpy as np
import pytest
import torch

import paddle_hackathon_tpu as paddle
from paddle_hackathon_tpu.optimizer import lr as jlr
from paddle_hackathon_tpu_torch.optimizer import SGD, Adam
from paddle_hackathon_tpu_torch.optimizer import lr as tlr

STEPS = 30

SCHEDULERS = {
    "NoamDecay": lambda m: m.NoamDecay(d_model=64, warmup_steps=5,
                                       learning_rate=2.0),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([4, 11, 20],
                                                 [0.1, 0.05, 0.01, 0.001]),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.5, gamma=0.1),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.5, gamma=0.3),
    "PolynomialDecay": lambda m: m.PolynomialDecay(0.1, decay_steps=7,
                                                   end_lr=0.001, power=2.0,
                                                   cycle=True),
    "LinearWarmup": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(0.1, T_max=12), warmup_steps=5,
        start_lr=0.0, end_lr=0.1),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.1, gamma=0.9),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.1, milestones=[3, 9, 17],
                                                 gamma=0.5),
    "StepDecay": lambda m: m.StepDecay(0.1, step_size=4, gamma=0.7),
    "LambdaDecay": lambda m: m.LambdaDecay(0.1, lambda e: 0.95 ** e),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(
        0.1, T_max=9, eta_min=0.001),
    "CyclicLR": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=4,
                                     step_size_down=6, mode="triangular2"),
    "OneCycleLR": lambda m: m.OneCycleLR(0.1, total_steps=25,
                                         phase_pct=0.4),
    "ReduceOnPlateau": lambda m: m.ReduceOnPlateau(0.1, factor=0.5,
                                                   patience=2, cooldown=1,
                                                   min_lr=0.002),
    "MultiplicativeDecay": lambda m: m.MultiplicativeDecay(
        0.1, lambda e: 0.9 if e % 3 else 1.1),
}


def _metric(i):
    # falls, stalls, falls again: ReduceOnPlateau's patience and cooldown
    # both come into play
    return float([5, 4, 4, 4, 4, 3, 3, 3, 3, 3][i % 10] - i // 10)


def _advance(sched, i, plateau):
    if plateau:
        sched.step(_metric(i))
    else:
        sched.step()
    return sched()


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_series_and_state_match_jax(name):
    plateau = name == "ReduceOnPlateau"
    j, t = SCHEDULERS[name](jlr), SCHEDULERS[name](tlr)
    assert t() == j()
    jl = [_advance(j, i, plateau) for i in range(STEPS)]
    tl = [_advance(t, i, plateau) for i in range(STEPS)]
    assert tl == jl
    assert len(set(tl)) > 1
    state = t.state_dict()
    assert state == j.state_dict()
    # a fresh scheduler resumes from the saved state
    resumed = SCHEDULERS[name](tlr)
    resumed.set_state_dict(dict(state))
    assert resumed() == t()
    ahead = [_advance(t, i, plateau) for i in range(STEPS, STEPS + 8)]
    assert [_advance(resumed, i, plateau)
            for i in range(STEPS, STEPS + 8)] == ahead


def test_reduce_on_plateau_takes_tensor_metrics():
    sched = tlr.ReduceOnPlateau(1.0, patience=0)
    sched.step(torch.tensor(3.0))
    sched.step(torch.tensor([3.0]))
    sched.step(np.float32(3.0))
    assert sched() == pytest.approx(0.01)
    sched.step()      # no metric: nothing moves
    assert sched.last_epoch == 3


def test_optimizer_follows_scheduler_and_saves_it():
    """SGD's step reads the scheduler each step; ``set_lr`` refuses a
    scheduler; the optimizer's ``state_dict`` carries the scheduler's."""
    w0 = np.arange(6, dtype=np.float32).reshape(2, 3)
    g = np.full((2, 3), 0.5, np.float32)
    jw = paddle.create_parameter([2, 3], "float32")
    jw._set_value(paddle.to_tensor(w0)._value)
    jsched = jlr.StepDecay(0.1, step_size=2, gamma=0.5)
    jopt = paddle.optimizer.SGD(learning_rate=jsched, parameters=[jw])
    tw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    tsched = tlr.StepDecay(0.1, step_size=2, gamma=0.5)
    topt = SGD(learning_rate=tsched, parameters=[tw])
    for _ in range(5):
        loss = paddle.sum(jw * paddle.to_tensor(g))
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        jsched.step()
        tw.grad = torch.from_numpy(g)
        topt.step()
        topt.clear_grad()
        tsched.step()
        assert topt.get_lr() == jopt.get_lr()
    np.testing.assert_allclose(tw.detach().numpy(), np.asarray(jw.numpy()),
                               rtol=0, atol=1e-6)
    with pytest.raises(RuntimeError, match="scheduler"):
        topt.set_lr(0.5)
    state = topt.state_dict()
    assert state["LR_Scheduler"] == jopt.state_dict()["LR_Scheduler"]
    other = Adam(learning_rate=tlr.StepDecay(0.1, step_size=2, gamma=0.5),
                 parameters=[tw])
    other.set_state_dict(state)
    assert other.get_lr() == topt.get_lr() and other._step_count == 5
