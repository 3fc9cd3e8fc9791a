"""The port's metrics, losses and activations against the JAX package's.

- Each metric (``accuracy``, ``Accuracy`` with top-k, ``Precision``,
  ``Recall``, ``Auc``) on seeded inputs: counts exactly, ``Auc`` at f32
  rtol 1e-6.
- Each loss functional and layer, and each activation functional and
  layer, through both packages' dygraph tapes from the same numpy inputs:
  the output and the gradient of a seeded weighted sum of it with respect
  to every float input, at f32 rtol 1e-5 / atol 1e-6.
- The random ones by their properties (the two packages draw from
  different generators): ``rrelu`` in training, ``gumbel_softmax``,
  ``class_center_sample``; and the model-parallel ``group`` refusing.
"""

import numpy as np
import pytest
import torch

import paddle_hackathon_tpu as jp
import paddle_hackathon_tpu_torch as tp

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")


def _rng(seed=0):
    return np.random.RandomState(seed)


# -- metrics -----------------------------------------------------------------

def _metric_case(mod, name):
    rng = _rng(1)
    pred = rng.rand(40, 5).astype(np.float32)
    label = rng.randint(0, 5, (40, 1))
    prob = rng.rand(40).astype(np.float32)
    binary = rng.randint(0, 2, 40)
    m = mod.metric
    if name == "accuracy_fn":
        return [float(m.accuracy(mod.to_tensor(pred), mod.to_tensor(label),
                                 k=k)) for k in (1, 2)]
    if name == "accuracy_topk":
        acc = m.Accuracy(topk=(1, 3))
        for lo in (0, 20):
            c = acc.compute(mod.to_tensor(pred[lo:lo + 20]),
                            mod.to_tensor(label[lo:lo + 20]))
            acc.update(c.numpy())
        return acc.accumulate(), acc.name(), acc.count.tolist()
    if name in ("precision", "recall"):
        met = m.Precision() if name == "precision" else m.Recall()
        for lo in (0, 20):
            met.update(prob[lo:lo + 20], binary[lo:lo + 20])
        return met.accumulate(), met.name()
    if name == "auc":
        auc = m.Auc(num_thresholds=255)
        two = np.stack([1 - prob, prob], 1)
        for lo in (0, 20):
            auc.update(mod.to_tensor(two[lo:lo + 20]), binary[lo:lo + 20])
        return auc.accumulate()
    raise KeyError(name)


@pytest.mark.parametrize("name", ["accuracy_fn", "accuracy_topk",
                                  "precision", "recall", "auc"])
def test_metrics_match_jax(name):
    want, got = _metric_case(jp, name), _metric_case(tp, name)
    if name == "auc":
        np.testing.assert_allclose(got, want, rtol=1e-6)
        assert 0 < got < 1
    else:
        assert got == want


def test_accuracy_compute_stays_on_the_predictions_device():
    acc = tp.metric.Accuracy()
    pred = torch.rand(6, 4)
    out = acc.compute(pred, torch.randint(0, 4, (6,)))
    assert isinstance(out, tp.Tensor) and out.shape == [6, 1]
    assert out._value.device == pred.device


# -- losses and activations through both tapes ------------------------------

def _f(shape, seed=0, lo=None, hi=None):
    r = _rng(seed)
    if lo is not None:
        return np.asarray(r.uniform(lo, hi, shape), np.float32)
    return np.asarray(r.randn(*shape), np.float32)


def _i(shape, n, seed=0):
    return _rng(seed).randint(0, n, shape).astype(np.int64)


def _pm1(shape, seed=0):
    return (_rng(seed).randint(0, 2, shape) * 2 - 1).astype(np.float32)


def _ctc_inputs():
    lp = np.log(np.clip(_f((6, 2, 5), 3, 0.05, 1.0), 1e-6, None))
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    return [lp.astype(np.float32), np.array([[1, 2, 2], [3, 1, 0]]),
            np.array([6, 5]), np.array([3, 2])]


def _hsig_inputs():
    return [_f((4, 6), 1), _i((4, 1), 7, 2), 7, _f((6, 6), 3), _f((6, 1), 4)]


# name -> (functional path under nn.functional, or a layer as
# ("Layer", ctor kwargs), inputs, float-input indices to differentiate,
# keyword arguments)
_LOSSES = {
    "cross_entropy_layer": (("CrossEntropyLoss", {}), [_f((5, 7)),
                                                       _i((5,), 7)], [0], {}),
    "cross_entropy_smooth_layer": (("CrossEntropyLoss",
                                    {"label_smoothing": 0.1}),
                                   [_f((5, 7)), _i((5,), 7)], [0], {}),
    "softmax_with_cross_entropy": ("softmax_with_cross_entropy",
                                   [_f((5, 7)), _i((5, 1), 7)], [0], {}),
    "nll_loss": ("nll_loss", [_f((6, 5)), _i((6,), 5)], [0], {}),
    "nll_loss_weighted": ("nll_loss", [_f((6, 5)), np.array(
        [0, 1, 4, -100, 2, 3]), _f((5,), 1, 0.5, 2.0)], [0],
        {"ignore_index": -100}),
    "nll_layer": (("NLLLoss", {"reduction": "sum"}), [_f((6, 5)),
                                                      _i((6,), 5)], [0], {}),
    "mse_loss": ("mse_loss", [_f((3, 4)), _f((3, 4), 1)], [0, 1], {}),
    "mse_layer": (("MSELoss", {"reduction": "sum"}),
                  [_f((3, 4)), _f((3, 4), 1)], [0], {}),
    "l1_loss": ("l1_loss", [_f((3, 4)), _f((3, 4), 1)], [0, 1],
                {"reduction": "none"}),
    "l1_layer": (("L1Loss", {}), [_f((3, 4)), _f((3, 4), 1)], [0], {}),
    "smooth_l1_loss": ("smooth_l1_loss", [_f((3, 4)), _f((3, 4), 1)],
                       [0, 1], {"delta": 0.7}),
    "smooth_l1_layer": (("SmoothL1Loss", {"delta": 0.5}),
                        [_f((3, 4)), _f((3, 4), 1)], [0], {}),
    "binary_cross_entropy": ("binary_cross_entropy",
                             [_f((4, 3), 0, 0.05, 0.95),
                              _i((4, 3), 2, 1).astype(np.float32),
                              _f((4, 3), 2, 0.5, 1.5)], [0], {}),
    "bce_layer": (("BCELoss", {}), [_f((4, 3), 0, 0.05, 0.95),
                                    _i((4, 3), 2, 1).astype(np.float32)],
                  [0], {}),
    "bce_with_logits": ("binary_cross_entropy_with_logits",
                        [_f((4, 3)), _i((4, 3), 2, 1).astype(np.float32)],
                        [0], {}),
    "bce_with_logits_pos_weight": ("binary_cross_entropy_with_logits",
                                   [_f((4, 3)), _i((4, 3), 2, 1).astype(
                                       np.float32), _f((4, 3), 3, 0.5, 1.5),
                                    "mean", _f((3,), 4, 0.5, 2.0)],
                                   [0], {}),
    "bce_with_logits_layer": (("BCEWithLogitsLoss", {}),
                              [_f((4, 3)), _i((4, 3), 2, 1).astype(
                                  np.float32)], [0], {}),
    "kl_div": ("kl_div", [np.log(_f((4, 5), 0, 0.1, 1.0)),
                          _f((4, 5), 1, 0.0, 1.0)], [0],
               {"reduction": "batchmean"}),
    "kl_div_layer": (("KLDivLoss", {"reduction": "sum"}),
                     [np.log(_f((4, 5), 0, 0.1, 1.0)),
                      _f((4, 5), 1, 0.0, 1.0)], [0], {}),
    "hinge_embedding_loss": ("hinge_embedding_loss", [_f((4, 5)),
                                                      _pm1((4, 5), 1)],
                             [0], {"margin": 0.5}),
    "hinge_layer": (("HingeEmbeddingLoss", {}), [_f((4, 5)),
                                                 _pm1((4, 5), 1)], [0], {}),
    "margin_ranking_loss": ("margin_ranking_loss",
                            [_f((6,)), _f((6,), 1), _pm1((6,), 2)], [0, 1],
                            {"margin": 0.1}),
    "margin_ranking_layer": (("MarginRankingLoss", {"margin": 0.2}),
                             [_f((6,)), _f((6,), 1), _pm1((6,), 2)], [0, 1],
                             {}),
    "cosine_embedding_loss": ("cosine_embedding_loss",
                              [_f((5, 4)), _f((5, 4), 1), _pm1((5,), 2)],
                              [0, 1], {"margin": 0.1}),
    "cosine_layer": (("CosineEmbeddingLoss", {}),
                     [_f((5, 4)), _f((5, 4), 1), _pm1((5,), 2)], [0, 1], {}),
    "triplet_margin_loss": ("triplet_margin_loss",
                            [_f((5, 4)), _f((5, 4), 1), _f((5, 4), 2)],
                            [0, 1, 2], {"swap": True}),
    "triplet_layer": (("TripletMarginLoss", {"p": 1.0}),
                      [_f((5, 4)), _f((5, 4), 1), _f((5, 4), 2)], [0, 1, 2],
                      {}),
    "ctc_loss": ("ctc_loss", _ctc_inputs(), [0], {}),
    "ctc_layer": (("CTCLoss", {"reduction": "sum"}), _ctc_inputs(), [0], {}),
    "square_error_cost": ("square_error_cost", [_f((3, 4)), _f((3, 4), 1)],
                          [0, 1], {}),
    "sigmoid_focal_loss": ("sigmoid_focal_loss",
                           [_f((4, 3)), _i((4, 3), 2, 1).astype(np.float32),
                            np.array([3.0], np.float32)], [0], {}),
    "dice_loss": ("dice_loss", [_f((2, 3, 4), 0, 0.05, 1.0),
                                _i((2, 3, 1), 4, 1)], [0], {}),
    "log_loss": ("log_loss", [_f((4, 1), 0, 0.05, 0.95),
                              _i((4, 1), 2, 1).astype(np.float32)], [0], {}),
    "soft_margin_loss": ("soft_margin_loss", [_f((4, 3)), _pm1((4, 3), 1)],
                         [0], {}),
    "soft_margin_layer": (("SoftMarginLoss", {}),
                          [_f((4, 3)), _pm1((4, 3), 1)], [0], {}),
    "multi_label_soft_margin_loss": ("multi_label_soft_margin_loss",
                                     [_f((4, 3)), _i((4, 3), 2, 1).astype(
                                         np.float32), _f((3,), 2, 0.5, 1.5)],
                                     [0], {}),
    "multi_label_layer": (("MultiLabelSoftMarginLoss", {}),
                          [_f((4, 3)), _i((4, 3), 2, 1).astype(np.float32)],
                          [0], {}),
    "triplet_with_distance": ("triplet_margin_with_distance_loss",
                              [_f((5, 4)), _f((5, 4), 1), _f((5, 4), 2)],
                              [0, 1, 2], {"swap": True}),
    "triplet_with_distance_layer": (("TripletMarginWithDistanceLoss", {}),
                                    [_f((5, 4)), _f((5, 4), 1),
                                     _f((5, 4), 2)], [0, 1, 2], {}),
    "npair_loss": ("npair_loss", [_f((6, 4)), _f((6, 4), 1),
                                  _i((6,), 3, 2)], [0, 1], {}),
    "hsigmoid_loss": ("hsigmoid_loss", _hsig_inputs(), [0, 3, 4], {}),
    "margin_cross_entropy": ("margin_cross_entropy",
                             [_f((5, 6), 0, -0.9, 0.9), _i((5,), 6, 1)],
                             [0], {"return_softmax": True}),
}

_ACTS = {name: (name, [_f((4, 6), 9)], [0], {}) for name in (
    "relu", "relu6", "sigmoid", "tanh", "gelu", "silu", "swish", "mish",
    "leaky_relu", "elu", "selu", "celu", "hardtanh", "hardsigmoid",
    "hardswish", "hardshrink", "softshrink", "tanhshrink", "thresholded_relu",
    "softplus", "softsign", "softmax", "log_softmax", "log_sigmoid", "glu")}
_ACTS.update({
    "gelu_tanh": ("gelu", [_f((4, 6), 9)], [0], {"approximate": True}),
    "leaky_relu_slope": ("leaky_relu", [_f((4, 6), 9)], [0],
                         {"negative_slope": 0.2}),
    "elu_alpha": ("elu", [_f((4, 6), 9)], [0], {"alpha": 0.5}),
    "celu_alpha": ("celu", [_f((4, 6), 9)], [0], {"alpha": 2.0}),
    "softplus_beta": ("softplus", [_f((4, 6), 9) * 8], [0],
                      {"beta": 2.0, "threshold": 5.0}),
    "softmax_axis0": ("softmax", [_f((4, 6), 9)], [0], {"axis": 0}),
    "prelu": ("prelu", [_f((2, 3, 4), 9), _f((3,), 1, 0.1, 0.5)], [0, 1],
              {}),
    "maxout": ("maxout", [_f((2, 6, 3), 9)], [0], {"groups": 2}),
    "rrelu_eval": ("rrelu", [_f((4, 6), 9)], [0], {"training": False}),
})
_ACT_LAYERS = {
    "ReLU": {}, "ReLU6": {}, "Sigmoid": {}, "Tanh": {}, "SiLU": {},
    "Swish": {}, "Mish": {}, "Hardswish": {}, "Hardsigmoid": {},
    "Softsign": {}, "Tanhshrink": {}, "LogSigmoid": {}, "GELU": {},
    "LeakyReLU": {"negative_slope": 0.1}, "ELU": {}, "CELU": {},
    "SELU": {}, "Hardtanh": {"min": -0.5, "max": 0.5}, "Hardshrink": {},
    "Softshrink": {}, "ThresholdedReLU": {"threshold": 0.3},
    "Softplus": {}, "Softmax": {}, "LogSoftmax": {}, "GLU": {},
    "Softmax2D": {}, "Silu": {}, "Maxout": {"groups": 3},
}
for _name, _kw in _ACT_LAYERS.items():
    _ACTS["layer_" + _name] = ((_name, _kw), [_f((2, 6, 4), 9)], [0], {})
_CASES = {**{"loss_" + k: v for k, v in _LOSSES.items()},
          **{"act_" + k: v for k, v in _ACTS.items()}}


def _through_tape(mod, case):
    path, inputs, diff, kw = case
    args = []
    for k, a in enumerate(inputs):
        if isinstance(a, np.ndarray):
            args.append(mod.to_tensor(a, stop_gradient=k not in diff))
        else:
            args.append(a)
    if isinstance(path, tuple):
        fn = getattr(mod.nn, path[0])(**path[1])
    else:
        fn = getattr(mod.nn.functional, path)
    outs = fn(*args, **kw)
    outs = list(outs) if isinstance(outs, (tuple, list)) else [outs]
    total = None
    for j, o in enumerate(outs):
        cot = mod.to_tensor(_f(tuple(o.shape), 100 + j))
        term = (o * cot).sum()
        total = term if total is None else total + term
    total.backward()
    vals = [np.asarray(o.numpy()) for o in outs]
    grads = [np.asarray(args[k].grad.numpy()) for k in diff]
    return vals, grads


@pytest.mark.parametrize("name", sorted(_CASES))
def test_losses_and_activations_match_jax(name):
    (jv, jg), (tv, tg) = (_through_tape(m, _CASES[name]) for m in (jp, tp))
    assert len(tv) == len(jv) and len(tg) == len(jg)
    for a, b in zip(tv, jv):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_inplace_activations_rebind():
    for name, ref in (("relu_", "relu"), ("tanh_", "tanh"), ("elu_", "elu"),
                      ("softmax_", "softmax")):
        x = tp.to_tensor(_f((3, 4), 5))
        want = getattr(tp.nn.functional, ref)(x).numpy()
        out = getattr(tp.nn.functional, name)(x)
        assert out is x
        np.testing.assert_array_equal(x.numpy(), want)


def test_random_activations_by_their_properties():
    F = tp.nn.functional
    tp.seed(3)
    x = torch.from_numpy(_f((64, 8), 9))
    y = F.rrelu(x, 0.1, 0.3, training=True)
    neg = x < 0
    ratio = y[neg] / x[neg]
    assert torch.equal(y[~neg], x[~neg])
    assert bool(((ratio >= 0.1) & (ratio <= 0.3)).all())
    g = F.gumbel_softmax(x, temperature=0.5)
    torch.testing.assert_close(g.sum(-1), torch.ones(64))
    h = F.gumbel_softmax(x, hard=True)
    torch.testing.assert_close(h.sum(-1), torch.ones(64))
    assert torch.equal((h > 0.5).sum(-1), torch.ones(64, dtype=torch.long))


def test_class_center_sample_and_the_group_refusal():
    F = tp.nn.functional
    tp.seed(1)
    label = torch.tensor([3, 7, 3, 11, 0])
    remap, sampled = F.class_center_sample(label, num_classes=20,
                                           num_samples=8)
    s = sampled.tolist()
    assert len(s) == 8 and s == sorted(set(s))
    assert {0, 3, 7, 11} <= set(s)
    assert [s[i] for i in remap.tolist()] == label.tolist()
    with pytest.raises(NotImplementedError, match="item 12"):
        F.class_center_sample(label, 20, 8, group="mp")
    with pytest.raises(NotImplementedError, match="item 12"):
        F.margin_cross_entropy(torch.rand(2, 4), torch.tensor([0, 1]),
                               group="mp")
