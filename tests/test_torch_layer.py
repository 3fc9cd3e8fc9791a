"""The port's ``Layer`` surface (``nn/layer.py``, ``nn/parameter.py``,
``nn/initializer.py``, ``nn/container.py``), ``cross_entropy``'s soft
labels / ``weight`` / ``label_smoothing`` / ``use_softmax=False``, and
the per-parameter learning rate, against the JAX package.

- The ``Layer`` cases of ``tests/test_nn.py`` (registration, train/eval,
  hooks, the ``state_dict`` round trip, containers), each compared with
  the JAX package's observation.  The port has no ``nn.ReLU`` yet
  (ROADMAP item 11): a two-line ``Layer`` stands in for it.
- ``set_state_dict``'s missing and unexpected keys and its ``ValueError``
  on a shape mismatch; ``create_parameter`` with a ``ParamAttr``.
- ``functional_state`` / ``functional_call``: values, and gradients
  through ``functional_call`` against ``jax.grad`` through the JAX
  package's.
- The 11 initializers: ``Constant``, ``Assign``, ``Dirac`` and the fan
  formulas exactly; the random ones by bounds and moments (torch cannot
  reproduce JAX's draws); ``Orthogonal`` by orthogonality.
- ``cross_entropy``'s four new options, singly and combined with
  ``ignore_index`` and each reduction: values and gradients.
- A ``ParamAttr(learning_rate=0.1)`` layer moves as in the JAX package
  through the eager ``step()`` and through ``make_functional_train_step``.

f32 at rtol 1e-5 / atol 1e-6 unless a check says why not.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_hackathon_tpu as jp
import paddle_hackathon_tpu_torch as tp
from paddle_hackathon_tpu import nn as jnn
from paddle_hackathon_tpu.nn import functional as jF
from paddle_hackathon_tpu.nn import initializer as jI
from paddle_hackathon_tpu.nn.layer import functional_call as jfunctional_call
from paddle_hackathon_tpu.parallel.api import \
    make_functional_train_step as jmake_functional_train_step
from paddle_hackathon_tpu_torch import nn as tnn
from paddle_hackathon_tpu_torch import optimizer as toptim
from paddle_hackathon_tpu_torch.nn import functional as tF
from paddle_hackathon_tpu_torch.nn import initializer as tI
from paddle_hackathon_tpu_torch.nn.layer import functional_call
from paddle_hackathon_tpu_torch.parallel import make_functional_train_step

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")
    yield


def _np(t):
    if isinstance(t, jp.Tensor):
        return np.asarray(t._value)
    return t.numpy() if hasattr(t, "numpy") else np.asarray(t)


class _ReLU(tnn.Layer):
    def forward(self, x):
        return torch.relu(x)


def _copy_weights(jlayer, tlayer):
    missing, unexpected = tlayer.set_state_dict(
        {k: np.asarray(v._value) for k, v in jlayer.state_dict().items()})
    assert not missing and not unexpected


# -- the Layer cases of tests/test_nn.py ------------------------------------
def test_layer_registration():
    def build(nn, p):
        class M(nn.Layer):
            def __init__(self):
                super().__init__()
                self.fc = nn.Linear(4, 3)
                self.w = p.create_parameter([2, 2])
                self.register_buffer("buf", p.to_tensor([1.0]))

            def forward(self, x):
                return self.fc(x)
        return M()

    obs = {}
    for nn, p in ((jnn, jp), (tnn, tp)):
        m = build(nn, p)
        obs[p] = (sorted(dict(m.named_parameters())), len(m.parameters()),
                  sorted(m.state_dict()), isinstance(m.fc, nn.Linear),
                  [type(s).__name__ for s in m.sublayers()])
    assert obs[jp] == obs[tp]
    assert "buf" in obs[tp][2] and obs[tp][1] == 3


def test_layers_init_on_the_current_place_as_jax_does(monkeypatch):
    """``Linear``, ``Embedding`` and ``LayerNorm`` built with no weights
    loaded start as the JAX package's do (XavierUniform weight and zero
    bias; Normal(0, 1) rows; ones and zeros), on the current place, with
    Paddle's argument order.  Random draws differ between the two
    generators, so they are held by bounds and moments (std within 3% at
    60,000 draws, whose sampling error is about 0.3%)."""
    lin = {p: nn.Linear(300, 200) for nn, p in ((jnn, jp), (tnn, tp))}
    emb = {p: nn.Embedding(400, 150) for nn, p in ((jnn, jp), (tnn, tp))}
    ln = {p: nn.LayerNorm(8) for nn, p in ((jnn, jp), (tnn, tp))}
    bound = np.sqrt(6.0 / (300 + 200))
    for p in (jp, tp):
        w = _np(lin[p].weight)
        assert w.shape == (300, 200) and np.abs(w).max() <= bound
        np.testing.assert_allclose(w.std(), bound / np.sqrt(3), rtol=3e-2)
        assert abs(w.mean()) < 3e-3
        np.testing.assert_array_equal(_np(lin[p].bias), np.zeros(200))
        e = _np(emb[p].weight)
        np.testing.assert_allclose(e.std(), 1.0, rtol=3e-2)
        assert abs(e.mean()) < 2e-2
        np.testing.assert_array_equal(_np(ln[p].weight), np.ones(8))
        np.testing.assert_array_equal(_np(ln[p].bias), np.zeros(8))
    np.testing.assert_allclose(_np(lin[tp].weight).std(),
                               _np(lin[jp].weight).std(), rtol=3e-2)
    for lay in (lin[tp], emb[tp], ln[tp]):
        assert all(q.device.type == "cpu" for q in lay.parameters())
    # a fresh port Linear trains: its output is a function of x, not of
    # stale memory, and matches the JAX layer's once the weights agree
    x = np.random.RandomState(0).randn(5, 300).astype(np.float32)
    t = lin[tp](tp.to_tensor(x))
    np.testing.assert_allclose(t.numpy(), x @ _np(lin[tp].weight),
                               rtol=RTOL, atol=1e-5)
    # Paddle's positional order: the third argument is weight_attr
    for nn, p in ((jnn, jp), (tnn, tp)):
        m = nn.Linear(3, 4, p.ParamAttr(initializer=nn.initializer.Constant(
            0.5)), False)
        assert m.bias is None
        np.testing.assert_array_equal(_np(m.weight), np.full((3, 4), 0.5))
    # padding_idx rows come out zero, as in the JAX package
    ids = np.array([[0, 2, 1, 2]], np.int32)
    je, te = jnn.Embedding(4, 3, padding_idx=2), tnn.Embedding(
        4, 3, padding_idx=2)
    _copy_weights(je, te)
    np.testing.assert_array_equal(_np(te(tp.to_tensor(ids))),
                                  _np(je(jp.to_tensor(ids))))
    # with no set_device the place is the card; on a machine without one
    # a layer still builds, on the CPU (to_tensor raises there instead)
    from paddle_hackathon_tpu_torch.core import device as tdevice
    monkeypatch.setattr(tdevice, "_current", None)
    want = "cuda" if torch.cuda.is_available() else "cpu"
    assert tnn.Linear(2, 2).weight.device.type == want
    assert tnn.LayerNorm(2).weight.device.type == want


def test_train_eval_mode():
    obs = {}
    for nn, p in ((jnn, jp), (tnn, tp)):
        m = nn.Sequential(nn.Linear(4, 4), nn.Dropout(0.5))
        first = m.training
        m.eval()
        evald = (m.training, m[1].training)
        x = p.randn([8, 4])
        np.testing.assert_allclose(_np(m(x)), _np(m(x)))  # deterministic
        m.train()
        obs[p] = (first, evald, m[1].training)
    assert obs[jp] == obs[tp] == (True, (False, False), True)


def test_forward_hooks():
    obs = {}
    for nn, p in ((jnn, jp), (tnn, tp)):
        m = nn.Linear(2, 2)
        calls = []
        h1 = m.register_forward_pre_hook(lambda layer, inp: calls.append(
            "pre"))
        h2 = m.register_forward_post_hook(
            lambda layer, inp, out: calls.append("post"))
        m(p.randn([1, 2]))
        h1.remove()
        h2.remove()
        m(p.randn([1, 2]))
        obs[p] = list(calls)
    assert obs[jp] == obs[tp] == ["pre", "post"]
    # a post hook that returns a value replaces the output
    m = tnn.Linear(2, 2)
    m.register_forward_post_hook(lambda layer, inp, out: out * 0)
    m.weight.data = torch.ones(2, 2)
    out = m(tp.to_tensor([[1.0, 2.0]]))
    assert isinstance(out, tp.Tensor)
    np.testing.assert_array_equal(out.numpy(), [[0.0, 0.0]])


def test_state_dict_roundtrip():
    j1 = jnn.Sequential(jnn.Linear(3, 4), jnn.ReLU(), jnn.Linear(4, 2))
    t1 = tnn.Sequential(tnn.Linear(3, 4), _ReLU(), tnn.Linear(4, 2))
    _copy_weights(j1, t1)
    t2 = tnn.Sequential(tnn.Linear(3, 4), _ReLU(), tnn.Linear(4, 2))
    missing, unexpected = t2.set_state_dict(t1.state_dict())
    assert not missing and not unexpected
    x = np.random.RandomState(1).randn(5, 3).astype(np.float32)
    want = _np(j1(jp.to_tensor(x)))
    for m in (t1, t2):
        np.testing.assert_allclose(m(tp.to_tensor(x)).numpy(), want,
                                   rtol=RTOL, atol=ATOL)
    assert sorted(t1.state_dict()) == sorted(j1.state_dict())


def test_containers():
    obs = {}
    for nn, p in ((jnn, jp), (tnn, tp)):
        ll = nn.LayerList([nn.Linear(2, 2) for _ in range(3)])
        n0 = len(ll)
        ll.append(nn.Linear(2, 2))
        ll.insert(1, nn.Identity())
        pl = nn.ParameterList([p.create_parameter([2])])
        pl.append(p.create_parameter([3]))
        ld = nn.LayerDict({"a": nn.Linear(2, 2)})
        ld["b"] = nn.Identity()
        popped = type(ld.pop("b")).__name__
        seq = nn.Sequential(("fc1", nn.Linear(2, 3)), ("fc2", nn.Linear(3, 1)))
        obs[p] = (n0, len(ll), len(list(ll[1:3])), type(ll[1]).__name__,
                  type(ll[-1]).__name__, len(list(pl)), "a" in ld,
                  list(ld.keys()), popped,
                  seq(p.randn([1, 2])).shape, type(seq[0]).__name__,
                  sorted(dict(seq.named_parameters())),
                  len(nn.Sequential(*[nn.Identity()] * 3)[1:]))
    assert obs[jp] == obs[tp]


def test_layer_names_buffers_and_casts():
    """``named_sublayers``, ``full_name``, a non-persistable buffer, the
    own-layer ``state_dict``, ``to`` / ``astype`` by Paddle's and torch's
    forms, against the JAX package's observations."""
    obs = {}
    for nn, p in ((jnn, jp), (tnn, tp)):
        outer = nn.Sequential(nn.Linear(2, 3), nn.Sequential(nn.Linear(3, 1)))
        outer.register_buffer("steps", p.to_tensor([0.0]),
                              persistable=False)
        outer.register_buffer("scale", p.to_tensor([2.0]))
        names = [n for n, _ in outer.named_sublayers(include_self=True)]
        own = sorted(outer.state_dict(include_sublayers=False))
        everything = sorted(outer.state_dict())
        outer.astype("float16")
        half = str(outer[0].weight.dtype).split(".")[-1]
        outer.to(dtype="float32")
        obs[p] = (names, own, everything, half,
                  str(outer[0].weight.dtype).split(".")[-1],
                  outer.full_name().rsplit("_", 1)[0])
    assert obs[jp] == obs[tp]
    m = tnn.Linear(2, 2)
    m.to(torch.bfloat16)
    assert m.weight.dtype == torch.bfloat16
    m.to("cpu", torch.float32)
    assert m.weight.dtype == torch.float32 and isinstance(
        m.weight, tp.Parameter)
    m.to(device="cpu")
    assert m.weight.device.type == "cpu"


# -- set_state_dict, create_parameter ----------------------------------------
def test_set_state_dict_keys_and_shape_mismatch():
    obs = {}
    for nn, p in ((jnn, jp), (tnn, tp)):
        m = nn.Sequential(nn.Linear(3, 4), nn.Linear(4, 2))
        sd = {k: np.ones(tuple(v.shape), np.float32)
              for k, v in m.state_dict().items()}
        sd.pop("1.bias")
        sd["extra.weight"] = np.zeros((2,), np.float32)
        missing, unexpected = m.set_state_dict(sd)
        np.testing.assert_array_equal(_np(m.state_dict()["0.weight"]),
                                      np.ones((3, 4)))
        with pytest.raises(ValueError, match="shape mismatch"):
            m.set_state_dict({"0.bias": np.zeros((5,), np.float32)})
        obs[p] = (missing, unexpected)
    assert obs[jp] == obs[tp] == (["1.bias"], ["extra.weight"])


def test_create_parameter_with_param_attr():
    for p, I in ((jp, jI), (tp, tI)):
        attr = p.ParamAttr(name="w_attr", initializer=I.Constant(0.25),
                           learning_rate=0.5, trainable=False)
        w = p.create_parameter([2, 3], attr=attr)
        assert w.name == "w_attr"
        assert w.optimize_attr["learning_rate"] == 0.5
        assert w.stop_gradient and not w.trainable
        np.testing.assert_array_equal(_np(w), np.full((2, 3), 0.25))
        b = p.create_parameter([3], is_bias=True)
        np.testing.assert_array_equal(_np(b), np.zeros(3))
        assert b.trainable and str(b.dtype).endswith("float32")
    # the port's Parameter is an nn.Parameter with Paddle's extra names
    w = tp.create_parameter([2, 3], attr=tp.ParamAttr(learning_rate=0.1))
    assert isinstance(w, torch.nn.Parameter) and w.requires_grad
    assert isinstance(w.shape, torch.Size)
    w.set_value(np.arange(6, dtype=np.float32))
    np.testing.assert_array_equal(w.numpy(), np.arange(6).reshape(2, 3))
    out = tp.matmul(tp.to_tensor(np.ones((1, 2), np.float32)), w)
    out.sum().backward()
    np.testing.assert_array_equal(w.gradient(), np.ones((2, 3)))
    assert str(w.astype("bfloat16").dtype) == "bfloat16"
    w.clear_grad()
    assert w.grad is None


# -- functional_state / functional_call --------------------------------------
def test_functional_call_values_and_grads_match_jax():
    jm = jnn.Sequential(jnn.Linear(3, 4), jnn.ReLU(), jnn.Linear(4, 2))
    tm = tnn.Sequential(tnn.Linear(3, 4), _ReLU(), tnn.Linear(4, 2))
    _copy_weights(jm, tm)
    jparams, jbufs = jm.functional_state()
    tparams, tbufs = tm.functional_state()
    assert sorted(jparams) == sorted(tparams) and not jbufs and not tbufs
    x = np.random.RandomState(2).randn(5, 3).astype(np.float32)
    w = np.random.RandomState(3).randn(5, 2).astype(np.float32)

    def jloss(params):
        out = jfunctional_call(jm, params, (jp.to_tensor(x),))
        return jnp.sum(out * w)
    jval, jgrads = jax.value_and_grad(jloss)(jparams)
    tps = {k: v.clone().requires_grad_() for k, v in tparams.items()}
    out = functional_call(tm, tps, (tp.to_tensor(x),), training=False)
    assert isinstance(out, torch.Tensor) and tm.training
    loss = (out * torch.from_numpy(w)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jval), rtol=RTOL)
    for k, g in jgrads.items():
        np.testing.assert_allclose(tps[k].grad.numpy(), np.asarray(g),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    # the layer's own parameters were not touched
    assert all(p.grad is None for p in tm.parameters())


# -- initializers ------------------------------------------------------------
def test_fan_formulas_match():
    from paddle_hackathon_tpu.nn.initializer import _fan_in_out as jfan
    from paddle_hackathon_tpu_torch.nn.initializer import _fan_in_out as tfan
    for shape in [(5,), (4, 6), (8, 3, 3, 3), (2, 4, 5)]:
        assert jfan(shape) == tfan(shape)


def test_deterministic_initializers_match_exactly():
    value = np.arange(12, dtype=np.float32).reshape(3, 4) / 7
    for jinit, tinit, shape in (
            (jI.Constant(0.7), tI.Constant(0.7), (3, 4)),
            (jI.Assign(value), tI.Assign(value), (3, 4)),
            (jI.Dirac(), tI.Dirac(), (4, 2, 3, 3)),
            (jI.Dirac(groups=2), tI.Dirac(groups=2), (4, 2, 3))):
        want = np.asarray(jinit(shape, jnp.float32))
        got = tinit(shape, "float32", device="cpu")
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["Normal", "TruncatedNormal", "Uniform",
                                  "XavierNormal", "XavierUniform",
                                  "KaimingNormal", "KaimingUniform",
                                  "Orthogonal"])
def test_random_initializers_by_moments(name):
    """Bounds and moments against the formula the JAX package uses (its
    draws hold to the same, within the sampling error)."""
    shape = (256, 384)
    fi, fo = shape
    spec = {
        "Normal": ((1.0, 0.5), dict(mean=1.0, std=0.5)),
        "TruncatedNormal": ((0.0, 0.5), dict(bound=1.0, std=0.5 * 0.8796)),
        "Uniform": ((-0.5, 1.5), dict(lo=-0.5, hi=1.5, mean=0.5)),
        "XavierNormal": ((), dict(std=math.sqrt(2.0 / (fi + fo)))),
        "XavierUniform": ((), dict(bound=math.sqrt(6.0 / (fi + fo)))),
        "KaimingNormal": ((), dict(std=math.sqrt(2.0 / fi))),
        "KaimingUniform": ((), dict(bound=math.sqrt(6.0 / fi))),
        "Orthogonal": ((1.5,), {}),
    }[name]
    args, want = spec
    tp.seed(5)
    got = getattr(tI, name)(*args)(shape, "float32", device="cpu").numpy()
    ref = np.asarray(getattr(jI, name)(*args)(shape, jnp.float32))
    assert got.shape == ref.shape == shape and got.dtype == np.float32
    if name == "Orthogonal":
        # fewer rows than columns: the rows are orthonormal (times gain)
        for m in (got, ref):
            np.testing.assert_allclose(m @ m.T / 1.5 ** 2, np.eye(fi),
                                       atol=1e-4)
        return
    for m in (got, ref):
        if "bound" in want:
            assert np.abs(m).max() <= want["bound"] * (1 + 1e-6)
            if "std" not in want:
                assert abs(m.std() - want["bound"] / math.sqrt(3)) \
                    < 0.02 * want["bound"]
        if "lo" in want:
            assert m.min() >= want["lo"] and m.max() <= want["hi"]
        if "mean" in want:
            assert abs(m.mean() - want["mean"]) < 0.01
        if "std" in want:
            assert abs(m.std() - want["std"]) < 0.02 * want["std"]
    tp.seed(5)
    again = getattr(tI, name)(*args)(shape, "float32", device="cpu")
    np.testing.assert_array_equal(again.numpy(), got)


# -- cross_entropy's options --------------------------------------------------
def _ce_inputs():
    rng = np.random.RandomState(11)
    logits = rng.randn(6, 5).astype(np.float32)
    hard = np.array([0, 3, -100, 4, 1, -100], np.int32)
    soft = rng.rand(6, 5).astype(np.float32)
    soft /= soft.sum(1, keepdims=True)
    weight = rng.uniform(0.2, 2.0, 5).astype(np.float32)
    probs = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True))
    return logits, hard, soft, weight, probs.astype(np.float32)


_CE_CASES = []
for _red in ("mean", "sum", "none"):
    _CE_CASES += [
        ("soft", dict(soft_label=True, reduction=_red)),
        ("soft_smooth", dict(soft_label=True, label_smoothing=0.1,
                             reduction=_red)),
        ("weight", dict(weight=True, reduction=_red)),
        ("smooth", dict(label_smoothing=0.15, reduction=_red)),
        ("probs", dict(use_softmax=False, reduction=_red)),
        ("weight_smooth", dict(weight=True, label_smoothing=0.1,
                               reduction=_red)),
        ("probs_weight", dict(use_softmax=False, weight=True,
                              reduction=_red)),
    ]


@pytest.mark.parametrize("kind,kw", _CE_CASES,
                         ids=[f"{k}-{kw['reduction']}" for k, kw in _CE_CASES])
def test_cross_entropy_options_match_jax(kind, kw):
    logits, hard, soft, weight, probs = _ce_inputs()
    kw = dict(kw)
    x = probs if kw.get("use_softmax") is False else logits
    label = soft if kw.get("soft_label") else hard
    results = {}
    for p, F in ((jp, jF), (tp, tF)):
        xt = p.to_tensor(x, stop_gradient=False)
        args = dict(kw)
        if args.pop("weight", False):
            args["weight"] = p.to_tensor(weight)
        loss = F.cross_entropy(xt, p.to_tensor(label), **args)
        (loss * p.to_tensor(np.linspace(0.5, 1.5, loss.size)
                            .reshape(loss.shape).astype(np.float32))
         ).sum().backward()
        results[p] = (loss, xt.grad, str(loss.dtype))
    (jl, jg, jd), (tl, tg, td) = results[jp], results[tp]
    assert isinstance(tl, tp.Tensor) and jd == td
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_np(tg), _np(jg), rtol=RTOL, atol=ATOL)


def test_cross_entropy_axis_and_torch_inputs():
    """Smoothing over ``axis=1`` of a (b, V, s) input; torch tensors in give
    a torch tensor out (the train step's calls are unchanged)."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 5, 3).astype(np.float32)
    lbl = np.array([[0, 4, -100], [2, 2, 1]], np.int32)
    want = jF.cross_entropy(jp.to_tensor(x), jp.to_tensor(lbl), axis=1,
                            label_smoothing=0.2)
    got = tF.cross_entropy(torch.from_numpy(x), torch.from_numpy(lbl),
                           axis=1, label_smoothing=0.2)
    assert isinstance(got, torch.Tensor) and not isinstance(got, tp.Tensor)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL,
                               atol=ATOL)


# -- the per-parameter learning rate (ParamAttr(learning_rate=)) -------------
def _lr_mlp(nn, p):
    class MLP(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(4, 8, weight_attr=p.ParamAttr(
                learning_rate=0.1))
            self.fc2 = nn.Linear(8, 2)

        def forward(self, x):
            return self.fc2(p.tanh(self.fc1(x)))
    return MLP()


def _lr_pair():
    jp.seed(3)
    jm = _lr_mlp(jnn, jp)
    tm = _lr_mlp(tnn, tp)
    _copy_weights(jm, tm)
    assert tm.fc1.weight.optimize_attr["learning_rate"] == 0.1
    return jm, tm


_LR_X = np.random.RandomState(8).randn(6, 4).astype(np.float32)
_LR_Y = np.random.RandomState(9).randn(6, 2).astype(np.float32)


def test_param_attr_learning_rate_eager_step():
    jm, tm = _lr_pair()
    jopt = jp.optimizer.Adam(learning_rate=0.05,
                             parameters=jm.parameters())
    topt = toptim.Adam(learning_rate=0.05, parameters=tm.parameters())
    start = tm.fc1.weight.detach().clone()
    for _ in range(3):
        for p, m, opt in ((jp, jm, jopt), (tp, tm, topt)):
            out = m(p.to_tensor(_LR_X))
            loss = ((out - p.to_tensor(_LR_Y)) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
    for name, jv in jm.state_dict().items():
        np.testing.assert_allclose(tm.state_dict()[name].numpy(),
                                   np.asarray(jv._value), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    # fc1's weight moved by about a tenth of Adam's step (an Adam step is
    # near lr in size): 3 steps at 0.005, not at 0.05
    moved = (tm.fc1.weight.detach() - start).abs().max().item()
    assert 0 < moved < 0.02


def test_param_attr_learning_rate_functional_step():
    jm, tm = _lr_pair()
    jnamed, tnamed = list(jm.named_parameters()), list(tm.named_parameters())
    order = [n for n, _ in tnamed]
    jopt = jp.optimizer.SGD(learning_rate=0.2,
                            parameters=[p for _, p in jnamed])
    topt = toptim.SGD(learning_rate=0.2, parameters=tnamed)

    def jgrads_of(params, xs, ys, step):
        def f(pp):
            out = jfunctional_call(jm, pp, (jp.to_tensor(xs),))
            return jnp.mean((out - ys) ** 2)
        return jax.value_and_grad(f)(params)

    def tgrads_of(params, xs, ys, step):
        ps = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss = ((functional_call(tm, ps, (xs,)) - ys) ** 2).mean()
        return loss.detach(), dict(zip(ps, torch.autograd.grad(
            loss, list(ps.values()))))

    jstep = jmake_functional_train_step(jopt, [p for _, p in jnamed], order,
                                        jgrads_of)
    tstep = make_functional_train_step(topt, [p for _, p in tnamed], order,
                                       tgrads_of)
    jps = {k: p._value for k, p in jnamed}
    tps = {k: p.detach() for k, p in tnamed}
    js, ts = jopt.functional_state([p for _, p in jnamed]), \
        topt.functional_state([p for _, p in tnamed])
    jt, tt = jnp.int32(0), 0
    for _ in range(3):
        jps, js, jt, _ = jstep(jps, js, jt, jnp.float32(0.2),
                               (jnp.asarray(_LR_X), jnp.asarray(_LR_Y)))
        tps, ts, tt, _ = tstep(tps, ts, tt, 0.2,
                               (torch.from_numpy(_LR_X),
                                torch.from_numpy(_LR_Y)))
    for k, v in jps.items():
        np.testing.assert_allclose(tps[k].numpy(), np.asarray(v), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    # the scale is what moved fc1.weight: without it the step differs
    lrs = toptim.optimizer.param_lrs_of([p for _, p in tnamed])
    assert lrs[order.index("fc1.weight")] == 0.1 and max(lrs) == 1.0
