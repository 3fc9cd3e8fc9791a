"""The port's common and norm functionals and layers, and ``nn.utils``
(``nn/functional/{common,norm}.py``, ``nn/layers/{common,norm}.py``,
``nn/utils/__init__.py``), against the JAX package.

- Every deterministic functional, forward and gradient (of ``sum(out *
  cot)`` for a fixed cotangent), the JAX side its functional under one
  ``jax.jit`` of ``jax.vjp`` a case (a third of the time of its eager
  tape, which the stateful ``batch_norm`` case keeps):
  ``interpolate`` in every mode, up and down; the four ``pad`` modes;
  ``unfold`` / ``fold`` with uneven padding; both grid samplers at both
  ``align_corners``; the norm functionals, ``batch_norm``'s running stats
  after 3 training calls among them.
- Every layer of the two files, on the JAX layer's weights: output and
  gradients to the input and to each parameter (the JAX side through its
  ``functional_call`` under one ``jax.jit``, a training BatchNorm on the
  tape); ``BatchNorm``'s running
  stats after 3 training calls; ``SpectralNorm``'s ``weight_u`` /
  ``weight_v``; ``SyncBatchNorm`` in one process and
  ``convert_sync_batchnorm``.
- ``weight_norm`` on and off, ``spectral_norm`` (its buffers and the
  gradient to ``weight_orig``), the parameter-vector helpers.
- The dropout family by statistics (torch cannot draw JAX's masks): the
  keep rate within 5 binomial sigmas, the scaling of each mode, the
  ``axis`` broadcast, the identity at eval.
- ``Dropout(p, axis, mode)``: the layer takes Paddle's arguments, and
  its default draw is the mask the layer has always drawn.

f32 at rtol 1e-5 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_hackathon_tpu as jp
import paddle_hackathon_tpu_torch as tp
from paddle_hackathon_tpu import nn as jnn
from paddle_hackathon_tpu.core.tensor import Tensor as JTensor
from paddle_hackathon_tpu.nn.layer import functional_call as jfcall
from paddle_hackathon_tpu.nn import functional as jF
from paddle_hackathon_tpu.nn import utils as jutils
from paddle_hackathon_tpu_torch import nn as tnn
from paddle_hackathon_tpu_torch.core.random import default_generator
from paddle_hackathon_tpu_torch.nn import functional as tF
from paddle_hackathon_tpu_torch.nn import utils as tutils
from paddle_hackathon_tpu_torch.utils import load_jax_state

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")
    yield


def _rng(seed=0):
    return np.random.RandomState(seed)


def _f(*shape, seed=0):
    return _rng(seed).randn(*shape).astype(np.float32)


def _is_float(a):
    return isinstance(a, np.ndarray) and a.dtype.kind == "f"


def _run_jax(fn, arrays, grads, cot_seed=99):
    """The JAX functional ``fn(jF, *args)`` and the gradients of
    ``sum(out * cot)`` to ``args[grads]``, traced once under ``jax.jit``."""
    def f(*xs):
        args = list(arrays)
        for i, x in zip(grads, xs):
            args[i] = x
        return fn(jF, *[JTensor(jnp.asarray(a)) if hasattr(a, "shape")
                        else a for a in args])._value

    @jax.jit
    def both(*xs):
        out, vjp = jax.vjp(f, *xs)
        if not grads:
            return out, ()
        cot = _rng(cot_seed).randn(*out.shape).astype(np.float32)
        return out, vjp(jnp.asarray(cot))
    out, g = both(*[jnp.asarray(arrays[i]) for i in grads])
    return np.asarray(out), [np.asarray(x) for x in g]


def _run_jax_tape(fn, arrays, grads, cot_seed=99):
    """As :func:`_run_jax`, op by op on the JAX package's tape (for a
    functional that updates state, which a trace cannot carry)."""
    ts = [jp.to_tensor(a, stop_gradient=i not in grads)
          if isinstance(a, np.ndarray) else a for i, a in enumerate(arrays)]
    out = fn(jF, *ts)
    o = np.asarray(out._value)
    if not grads:
        return o, []
    cot = _rng(cot_seed).randn(*o.shape).astype(np.float32)
    (out * jp.to_tensor(cot)).sum().backward()
    return o, [np.asarray(ts[i].grad._value) for i in grads]


def _run_port(fn, arrays, grads, cot_seed=99):
    ts = [torch.tensor(a).requires_grad_(i in grads)
          if isinstance(a, np.ndarray) else a for i, a in enumerate(arrays)]
    out = fn(tF, *ts)
    o = out.detach().numpy()
    if not grads:
        return o, []
    cot = torch.from_numpy(_rng(cot_seed).randn(*o.shape).astype(np.float32))
    g = torch.autograd.grad((out * cot).sum(), [ts[i] for i in grads])
    return o, [x.numpy() for x in g]


def _close(got, want, what=""):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


# (name, fn(F, *args), args, indices of the args to differentiate)
_IMG = _f(2, 3, 5, 6)
_IDS = np.array([[1, 0, 3], [2, 2, 0]], np.int32)
_CSR_OFF = np.tile(np.array([0, 2, 3, 5, 6], np.int32), (1, 2, 1))
_CSR_COL = np.tile(np.array([0, 2, 1, 0, 3, 3], np.int32), (1, 2, 1))
_FUNCS = [
    ("linear", lambda F, x, w, b: F.linear(x, w, b),
     [_f(4, 5), _f(5, 3, seed=1), _f(3, seed=2)], [0, 1, 2]),
    ("linear_no_bias", lambda F, x, w: F.linear(x, w),
     [_f(2, 4, 5), _f(5, 3, seed=1)], [0, 1]),
    ("embedding_padding_idx",
     lambda F, i, w: F.embedding(i, w, padding_idx=0),
     [_IDS, _f(4, 6)], [1]),
    ("one_hot", lambda F, i: F.one_hot(i, 5),
     [np.array([0, 3, 4, 7, -1], np.int32)], []),
    ("label_smooth", lambda F, l: F.label_smooth(l, epsilon=0.2),
     [_f(3, 5)], [0]),
    ("label_smooth_prior",
     lambda F, l, p: F.label_smooth(l, prior_dist=p, epsilon=0.1),
     [_f(3, 5), _f(1, 5, seed=1)], [0, 1]),
    ("normalize_p2", lambda F, x: F.normalize(x, axis=1), [_f(3, 4, 2)],
     [0]),
    ("normalize_p3", lambda F, x: F.normalize(x, p=3, axis=-1),
     [_f(3, 4)], [0]),
    ("cosine_similarity", lambda F, a, b: F.cosine_similarity(a, b, axis=1),
     [_f(3, 6), _f(3, 6, seed=1)], [0, 1]),
    ("pad_constant_nchw",
     lambda F, x: F.pad(x, [1, 2, 0, 1], value=0.5), [_IMG], [0]),
    ("pad_reflect_nchw", lambda F, x: F.pad(x, [2, 1, 1, 2], mode="reflect"),
     [_IMG], [0]),
    ("pad_replicate_nhwc",
     lambda F, x: F.pad(x, [1, 1, 2, 0], mode="replicate",
                        data_format="NHWC"), [_IMG], [0]),
    ("pad_circular_ncl", lambda F, x: F.pad(x, [2, 1], mode="circular",
                                           data_format="NCL"),
     [_f(2, 3, 5)], [0]),
    ("pad_every_dim", lambda F, x: F.pad(x, [0, 1, 1, 0, 2, 2]),
     [_f(2, 3, 4)], [0]),
    ("pixel_shuffle", lambda F, x: F.pixel_shuffle(x, 2),
     [_f(2, 8, 3, 2)], [0]),
    ("pixel_shuffle_nhwc",
     lambda F, x: F.pixel_shuffle(x, 2, data_format="NHWC"),
     [_f(2, 3, 2, 8)], [0]),
    ("pixel_unshuffle", lambda F, x: F.pixel_unshuffle(x, 2),
     [_f(2, 2, 4, 6)], [0]),
    ("pixel_unshuffle_nhwc",
     lambda F, x: F.pixel_unshuffle(x, 2, data_format="NHWC"),
     [_f(2, 4, 6, 2)], [0]),
    ("channel_shuffle", lambda F, x: F.channel_shuffle(x, 3),
     [_f(2, 6, 2, 3)], [0]),
    ("channel_shuffle_nhwc",
     lambda F, x: F.channel_shuffle(x, 2, data_format="NHWC"),
     [_f(2, 2, 3, 6)], [0]),
    ("unfold", lambda F, x: F.unfold(x, [2, 3], strides=[1, 2],
                                     paddings=[1, 0, 2, 1], dilations=1),
     [_IMG], [0]),
    ("unfold_dilated", lambda F, x: F.unfold(x, 2, strides=1, paddings=1,
                                             dilations=2), [_IMG], [0]),
    ("fold", lambda F, c: F.fold(c, [5, 6], [2, 3], strides=[1, 2],
                                 paddings=[1, 0, 2, 1]),
     [_f(2, 18, 5 * 4)], [0]),
    ("affine_grid", lambda F, th: F.affine_grid(th, [2, 3, 4, 5]),
     [_f(2, 2, 3)], [0]),
    ("affine_grid_unaligned",
     lambda F, th: F.affine_grid(th, [2, 3, 4, 5], align_corners=False),
     [_f(2, 2, 3)], [0]),
    ("grid_sample_bilinear", lambda F, x, g: F.grid_sample(x, g),
     [_IMG, np.clip(_f(2, 4, 3, 2, seed=3) * 0.7, -1.1, 1.1)], [0, 1]),
    ("grid_sample_bilinear_unaligned",
     lambda F, x, g: F.grid_sample(x, g, align_corners=False),
     [_IMG, np.clip(_f(2, 4, 3, 2, seed=3) * 0.7, -1.1, 1.1)], [0, 1]),
    ("grid_sample_nearest",
     lambda F, x, g: F.grid_sample(x, g, mode="nearest"),
     [_IMG, np.clip(_f(2, 4, 3, 2, seed=4) * 0.7, -1.1, 1.1)], [0]),
    ("grid_sample_nearest_unaligned",
     lambda F, x, g: F.grid_sample(x, g, mode="nearest",
                                   align_corners=False),
     [_IMG, np.clip(_f(2, 4, 3, 2, seed=4) * 0.7, -1.1, 1.1)], [0]),
    ("bilinear", lambda F, a, b, w, c: F.bilinear(a, b, w, c),
     [_f(3, 4), _f(3, 5, seed=1), _f(2, 4, 5, seed=2), _f(2, seed=3)],
     [0, 1, 2, 3]),
    ("diag_embed", lambda F, x: F.diag_embed(x), [_f(2, 3)], [0]),
    ("diag_embed_offset", lambda F, x: F.diag_embed(x, offset=1, dim1=0,
                                                    dim2=2),
     [_f(2, 3)], [0]),
    ("diag_embed_neg_offset", lambda F, x: F.diag_embed(x, offset=-2),
     [_f(2, 2, 3)], [0]),
    ("zeropad2d", lambda F, x: F.zeropad2d(x, [1, 0, 2, 1]), [_IMG], [0]),
    ("zeropad2d_nhwc",
     lambda F, x: F.zeropad2d(x, [0, 2, 1, 1], data_format="NHWC"),
     [_IMG], [0]),
    ("temporal_shift", lambda F, x: F.temporal_shift(x, 3, 0.25),
     [_f(6, 8, 2, 2)], [0]),
    ("temporal_shift_nhwc",
     lambda F, x: F.temporal_shift(x, 2, 0.25, data_format="NHWC"),
     [_f(4, 2, 2, 8)], [0]),
    ("gather_tree", lambda F, i, p: F.gather_tree(i, p),
     [_rng(5).randint(0, 9, (4, 2, 3)).astype(np.int32),
      _rng(6).randint(0, 3, (4, 2, 3)).astype(np.int32)], []),
    ("sparse_attention", lambda F, q, k, v, o, c: F.sparse_attention(
        q, k, v, o, c),
     [_f(1, 2, 4, 8), _f(1, 2, 4, 8, seed=1), _f(1, 2, 4, 8, seed=2),
      _CSR_OFF, _CSR_COL], [0, 1, 2]),
    # norm functionals
    ("batch_norm_eval", lambda F, x, m, v, w, b: F.batch_norm(
        x, m, v, w, b, training=False),
     [_IMG, _f(3, seed=1), np.abs(_f(3, seed=2)) + 0.5, _f(3, seed=3),
      _f(3, seed=4)], [0, 3, 4]),
    ("layer_norm", lambda F, x, w, b: F.layer_norm(x, 6, w, b),
     [_IMG, _f(6, seed=1), _f(6, seed=2)], [0, 1, 2]),
    ("layer_norm_2d_no_affine", lambda F, x: F.layer_norm(x, [5, 6]),
     [_IMG], [0]),
    ("group_norm", lambda F, x, w, b: F.group_norm(x, 2, 1e-5, w, b),
     [_f(2, 4, 3, 2), _f(4, seed=1), _f(4, seed=2)], [0, 1, 2]),
    ("group_norm_nhwc", lambda F, x, w, b: F.group_norm(
        x, 2, 1e-5, w, b, data_format="NHWC"),
     [_f(2, 3, 2, 4), _f(4, seed=1), _f(4, seed=2)], [0, 1, 2]),
    ("instance_norm", lambda F, x, w, b: F.instance_norm(x, weight=w,
                                                         bias=b),
     [_IMG, _f(3, seed=1), _f(3, seed=2)], [0, 1, 2]),
    ("local_response_norm", lambda F, x: F.local_response_norm(
        x, 3, alpha=0.1, beta=0.75, k=1.0), [_IMG], [0]),
    ("local_response_norm_nhwc", lambda F, x: F.local_response_norm(
        x, 4, alpha=0.2, data_format="NHWC"), [_f(2, 3, 2, 5)], [0]),
    ("rms_norm", lambda F, x, w: F.rms_norm(x, w), [_IMG, _f(6, seed=1)],
     [0, 1]),
]


@pytest.mark.parametrize("name,fn,arrays,grads", _FUNCS,
                         ids=[c[0] for c in _FUNCS])
def test_functional_matches_jax(name, fn, arrays, grads):
    jo, jg = _run_jax(fn, arrays, grads)
    to, tg = _run_port(fn, arrays, grads)
    assert to.shape == jo.shape and to.dtype == jo.dtype, (to.dtype, jo.dtype)
    _close(to, jo, name)
    for i, (a, b) in enumerate(zip(tg, jg)):
        _close(a, b, f"{name} grad {grads[i]}")


# interpolate: every mode, up and down, both layouts
_RESIZE = [
    ("nearest", _f(2, 3, 5, 6), dict(size=[7, 9])),
    ("nearest", _f(2, 3, 8, 6), dict(scale_factor=0.5)),
    ("bilinear", _f(2, 3, 5, 6), dict(size=[8, 11])),
    ("bilinear", _f(2, 3, 9, 8), dict(size=[4, 3])),
    ("bilinear", _f(2, 5, 6, 3), dict(scale_factor=[1.5, 0.5],
                                      data_format="NHWC")),
    ("bicubic", _f(2, 3, 5, 6), dict(scale_factor=2)),
    ("bicubic", _f(2, 3, 9, 7), dict(size=[5, 3])),
    ("linear", _f(2, 3, 7), dict(size=[12], data_format="NCW")),
    ("linear", _f(2, 3, 12), dict(size=[5], data_format="NCW")),
    ("trilinear", _f(1, 2, 4, 5, 3), dict(size=[6, 3, 5],
                                          data_format="NCDHW")),
    ("area", _f(2, 3, 8, 8), dict(size=[3, 5])),
    ("area", _f(2, 3, 4, 4), dict(size=[6, 7], align_corners=True)),
]


@pytest.mark.parametrize("mode,x,kw", _RESIZE,
                         ids=[f"{m}_{x.shape}_{sorted(kw)}"
                              for m, x, kw in _RESIZE])
def test_interpolate_matches_jax_resize(mode, x, kw):
    grads = [] if mode == "nearest" else [0]
    fn = lambda F, v: F.interpolate(v, mode=mode, **kw)  # noqa: E731
    jo, jg = _run_jax(fn, [x], grads)
    to, tg = _run_port(fn, [x], grads)
    assert to.shape == jo.shape
    _close(to, jo, mode)
    for a, b in zip(tg, jg):
        _close(a, b, mode + " grad")
    # upsample is interpolate
    up = tF.upsample(torch.tensor(x), mode=mode, **kw)
    np.testing.assert_array_equal(up.numpy(), to)


def test_batch_norm_running_stats_after_three_calls():
    """Training mode: the batch's biased variance normalises, the
    unbiased one enters the running update (momentum 0.9), in place;
    the batch statistics are constants to the gradient in both
    packages."""
    xs = [_f(4, 3, 2, 2, seed=s) * (s + 1) for s in range(3)]
    for fmt, perm in (("NCHW", None), ("NHWC", (0, 2, 3, 1))):
        jm, jv = jp.to_tensor(np.zeros(3, np.float32)), \
            jp.to_tensor(np.ones(3, np.float32))
        tm, tv = torch.zeros(3), torch.ones(3)
        for x in xs:
            x = x if perm is None else np.ascontiguousarray(x.transpose(perm))
            w, b = _f(3, seed=7), _f(3, seed=8)
            fn = (lambda F, v, w_, b_, m=None, s=None: F.batch_norm(  # noqa
                v, m, s, w_, b_, training=True, data_format=fmt))
            jo, jg = _run_jax_tape(
                lambda F, v, w_, b_: fn(F, v, w_, b_, jm, jv), [x, w, b],
                [0, 1, 2])
            to, tg = _run_port(lambda F, v, w_, b_: fn(F, v, w_, b_, tm, tv),
                               [x, w, b], [0, 1, 2])
            _close(to, jo, fmt)
            for a, c in zip(tg, jg):
                _close(a, c, fmt + " grad")
        _close(tm.numpy(), np.asarray(jm._value), fmt + " running mean")
        _close(tv.numpy(), np.asarray(jv._value), fmt + " running var")
    # use_global_stats: the running stats normalise and stay as they are
    before = tm.clone()
    tF.batch_norm(torch.tensor(xs[0]), tm, tv, training=True,
                  use_global_stats=True)
    assert torch.equal(tm, before)


# -- the layers, on the JAX layer's weights ---------------------------------
def _jax_layer(jlayer, inputs, flt, cot_seed=11):
    """The JAX layer's output and the gradients of ``sum(out * cot)`` to
    ``inputs[flt]`` and to its parameters (a dict), by ``functional_call``
    under one ``jax.jit`` of ``jax.vjp``."""
    params = {k: v._value for k, v in jlayer.named_parameters()}
    buffers = {k: v._value for k, v in jlayer.named_buffers()}

    def f(xs, ps):
        args = list(inputs)
        for i, x in zip(flt, xs):
            args[i] = x
        return jfcall(jlayer, ps, tuple(JTensor(jnp.asarray(a))
                                        for a in args), buffers=buffers)

    @jax.jit
    def both(xs, ps):
        out, vjp = jax.vjp(f, xs, ps)
        cot = _rng(cot_seed).randn(*out.shape).astype(np.float32)
        return out, vjp(jnp.asarray(cot))
    out, (gx, gp) = both([jnp.asarray(inputs[i]) for i in flt], params)
    return np.asarray(out), [np.asarray(g) for g in gx], \
        {k: np.asarray(v) for k, v in gp.items()}


def _jax_layer_tape(jlayer, inputs, flt, cot_seed=11):
    """As :func:`_jax_layer`, on the JAX package's tape (for a layer whose
    forward updates its buffers, which a trace cannot carry)."""
    jlayer.clear_gradients()
    jin = [jp.to_tensor(a, stop_gradient=i not in flt)
           for i, a in enumerate(inputs)]
    jo = jlayer(*jin)
    cot = _rng(cot_seed).randn(*jo.shape).astype(np.float32)
    (jo * jp.to_tensor(cot)).sum().backward()
    return np.asarray(jo._value), \
        [np.asarray(jin[i].grad._value) for i in flt], \
        {k: np.asarray(p.grad._value)
         for k, p in jlayer.named_parameters() if p.grad is not None}


def _layer_case(jlayer, tlayer, inputs, train=True, tape=False):
    """Copy the JAX layer's state into the port's, run both on
    ``inputs`` (numpy), compare the output and the gradients of
    ``sum(out * cot)`` to the float inputs and to every parameter."""
    load_jax_state(tlayer, {k: np.asarray(v._value)
                            for k, v in jlayer.state_dict().items()})
    jlayer.train() if train else jlayer.eval()
    tlayer.train() if train else tlayer.eval()
    flt = [i for i, a in enumerate(inputs) if _is_float(a)]
    jo, jgx, jgp = (_jax_layer_tape if tape else _jax_layer)(jlayer, inputs,
                                                              flt)
    tin = [torch.tensor(a).requires_grad_(i in flt)
           for i, a in enumerate(inputs)]
    to = tlayer(*tin)
    _close(to.detach().numpy(), jo, type(tlayer).__name__)
    cot = _rng(11).randn(*to.shape).astype(np.float32)
    names = [n for n, p in tlayer.named_parameters() if p.requires_grad]
    tp_params = dict(tlayer.named_parameters())
    g = torch.autograd.grad((to * torch.from_numpy(cot)).sum(),
                            [tin[i] for i in flt]
                            + [tp_params[n] for n in names])
    for gi, want in zip(g, jgx):
        _close(gi.numpy(), want, "input grad")
    for n, gi in zip(names, g[len(flt):]):
        _close(gi.numpy(), jgp[n], n)


_LAYERS = [
    ("Flatten", lambda nn: nn.Flatten(1, 2), [_IMG]),
    ("Upsample", lambda nn: nn.Upsample(size=[7, 4], mode="bilinear"),
     [_IMG]),
    ("UpsamplingBilinear2D",
     lambda nn: nn.UpsamplingBilinear2D(scale_factor=2), [_IMG]),
    ("UpsamplingNearest2D",
     lambda nn: nn.UpsamplingNearest2D(size=[3, 12]), [_IMG]),
    ("Pad1D", lambda nn: nn.Pad1D([1, 2], mode="reflect"), [_f(2, 3, 5)]),
    ("Pad2D", lambda nn: nn.Pad2D([1, 0, 2, 1], value=1.5), [_IMG]),
    ("Pad3D", lambda nn: nn.Pad3D([1, 1, 0, 2, 1, 0], mode="replicate"),
     [_f(1, 2, 3, 4, 3)]),
    ("ZeroPad2D", lambda nn: nn.ZeroPad2D([1, 2, 0, 1]), [_IMG]),
    ("PixelShuffle", lambda nn: nn.PixelShuffle(2), [_f(1, 8, 2, 3)]),
    ("PixelUnshuffle", lambda nn: nn.PixelUnshuffle(3), [_f(1, 2, 6, 3)]),
    ("ChannelShuffle", lambda nn: nn.ChannelShuffle(3), [_f(2, 6, 2, 2)]),
    ("Bilinear", lambda nn: nn.Bilinear(4, 5, 3),
     [_f(2, 4), _f(2, 5, seed=1)]),
    ("CosineSimilarity", lambda nn: nn.CosineSimilarity(axis=-1),
     [_f(3, 5), _f(3, 5, seed=1)]),
    ("Unfold", lambda nn: nn.Unfold([2, 2], strides=2), [_f(1, 2, 4, 6)]),
    ("Fold", lambda nn: nn.Fold([4, 6], [2, 2], strides=2),
     [_f(1, 8, 6)]),
    ("PairwiseDistance", lambda nn: nn.PairwiseDistance(p=3.0,
                                                        keepdim=True),
     [_f(4, 5), _f(4, 5, seed=1)]),
    ("Linear", lambda nn: nn.Linear(5, 3), [_f(2, 5)]),
    ("Embedding", lambda nn: nn.Embedding(6, 4, padding_idx=2), [_IDS]),
    ("BatchNorm1D_eval", lambda nn: nn.BatchNorm1D(4), [_f(5, 4)]),
    ("BatchNorm2D_eval_no_affine",
     lambda nn: nn.BatchNorm2D(3, weight_attr=False, bias_attr=False),
     [_IMG]),
    ("BatchNorm3D_train", lambda nn: nn.BatchNorm3D(2),
     [_f(2, 2, 3, 2, 2)]),
    ("BatchNorm_nhwc_train",
     lambda nn: nn.BatchNorm(6, momentum=0.8, data_format="NHWC"), [_IMG]),
    ("SyncBatchNorm_train", lambda nn: nn.SyncBatchNorm(3), [_IMG]),
    ("LayerNorm", lambda nn: nn.LayerNorm([5, 6]), [_IMG]),
    ("GroupNorm", lambda nn: nn.GroupNorm(3, 6), [_f(2, 6, 2, 3)]),
    ("InstanceNorm1D", lambda nn: nn.InstanceNorm1D(3), [_f(2, 3, 7)]),
    ("InstanceNorm2D", lambda nn: nn.InstanceNorm2D(3), [_IMG]),
    ("InstanceNorm3D_no_bias",
     lambda nn: nn.InstanceNorm3D(2, bias_attr=False), [_f(2, 2, 2, 3, 2)]),
    ("LocalResponseNorm", lambda nn: nn.LocalResponseNorm(5, alpha=0.5),
     [_f(2, 6, 2, 2)]),
    ("RMSNorm", lambda nn: nn.RMSNorm(6), [_IMG]),
]


@pytest.mark.parametrize("name,build,inputs", _LAYERS,
                         ids=[c[0] for c in _LAYERS])
def test_layer_matches_jax(name, build, inputs):
    jp.seed(3)
    jl = build(jnn)
    tl = build(tnn)
    # random affine parameters, so that their gradients are not trivial
    with torch.no_grad():
        sd = {k: np.asarray(v._value) for k, v in jl.state_dict().items()}
    for i, (k, v) in enumerate(sd.items()):
        if k in ("weight", "bias", "scale") and v.dtype.kind == "f":
            sd[k] = _f(*v.shape, seed=20 + i)
    jl.set_state_dict(sd)
    # a training BatchNorm updates its running stats: on the JAX tape
    _layer_case(jl, tl, inputs, train="eval" not in name,
                tape="train" in name)
    if "train" in name and "BatchNorm" in name:
        for k in ("_mean", "_variance"):
            _close(dict(tl.named_buffers())[k].numpy(),
                   np.asarray(dict(jl.named_buffers())[k]._value), k)


def test_batch_norm_layer_running_stats_after_three_calls():
    jp.seed(0)
    jl, tl = jnn.BatchNorm2D(3, momentum=0.7), tnn.BatchNorm2D(3,
                                                               momentum=0.7)
    load_jax_state(tl, {k: np.asarray(v._value)
                        for k, v in jl.state_dict().items()})
    assert sorted(tl.state_dict()) == sorted(jl.state_dict()) == \
        ["_mean", "_variance", "bias", "weight"]
    for s in range(3):
        x = _f(4, 3, 2, 2, seed=s) * (s + 2) + s
        jl(jp.to_tensor(x))
        tl(torch.tensor(x))
    for k in ("_mean", "_variance"):
        _close(tl.state_dict()[k].numpy(),
               np.asarray(jl.state_dict()[k]._value), k)
    # eval normalises with them
    x = _f(4, 3, 2, 2, seed=9)
    jl.eval(), tl.eval()
    _close(tl(torch.tensor(x)).detach().numpy(),
           np.asarray(jl(jp.to_tensor(x))._value))


def test_sync_batch_norm_converts_and_raises_across_ranks(monkeypatch):
    net = tnn.Sequential(tnn.Linear(3, 4), tnn.BatchNorm1D(4))
    tl = net[1]
    tl(torch.randn(5, 4))
    conv = tnn.SyncBatchNorm.convert_sync_batchnorm(net)
    assert isinstance(conv[1], tnn.SyncBatchNorm)
    for k, v in tl.state_dict().items():
        assert torch.equal(conv[1].state_dict()[k], v)
    x = torch.randn(5, 4)
    tl.eval(), conv.eval()
    assert torch.equal(conv[1](x), tl(x))
    dist = torch.distributed
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    with pytest.raises(NotImplementedError, match="item 12"):
        conv[1](x)
    # BatchNorm itself has no group to reduce over
    tl(x)


def test_spectral_norm_layer_matches_jax():
    """``weight_u`` / ``weight_v`` after three calls (two training, one
    eval: the JAX layer advances them in eval too) and the detached
    ``weight / sigma``."""
    jl, tl = jnn.SpectralNorm([4, 3, 2], dim=1, power_iters=2), \
        tnn.SpectralNorm([4, 3, 2], dim=1, power_iters=2)
    assert sorted(tl.state_dict()) == sorted(jl.state_dict()) == \
        ["weight_u", "weight_v"]
    for s, train in ((0, True), (1, True), (2, False)):
        w = _f(4, 3, 2, seed=s)
        jl.train() if train else jl.eval()
        tl.train() if train else tl.eval()
        wt = torch.tensor(w, requires_grad=True)
        jo, to = jl(jp.to_tensor(w)), tl(wt)
        _close(to.numpy(), np.asarray(jo._value))
        assert not to.requires_grad
    for k in ("weight_u", "weight_v"):
        _close(tl.state_dict()[k].numpy(),
               np.asarray(jl.state_dict()[k]._value), k)


# -- nn.utils -----------------------------------------------------------------
def _linear_pair(seed=4):
    jp.seed(seed)
    jl, tl = jnn.Linear(5, 3), tnn.Linear(5, 3)
    load_jax_state(tl, {k: np.asarray(v._value)
                        for k, v in jl.state_dict().items()})
    return jl, tl


@pytest.mark.parametrize("dim", [0, 1, None])
def test_weight_norm_on_and_off(dim):
    jl, tl = _linear_pair()
    jutils.weight_norm(jl, dim=dim)
    tutils.weight_norm(tl, dim=dim)
    assert list(tl.state_dict()) == list(jl.state_dict()) == \
        ["bias", "weight_v", "weight_g"]
    x = _f(2, 5)
    # a step of the direction and magnitude: the effective weight follows
    with torch.no_grad():
        sd = {k: np.asarray(v._value) * 1.5
              for k, v in jl.state_dict().items()}
    jl.set_state_dict(sd)
    tl.set_state_dict(sd)
    _layer_case(jl, tl, [x], tape=True)
    _close(tl.weight.detach().numpy(), np.asarray(jl.weight._value))
    jutils.remove_weight_norm(jl)
    tutils.remove_weight_norm(tl)
    assert list(tl.state_dict()) == list(jl.state_dict()) == \
        ["bias", "weight"]
    _layer_case(jl, tl, [x], tape=True)
    assert isinstance(tl.weight, tnn.Parameter)


def test_spectral_norm_matches_jax():
    jl, tl = _linear_pair(6)
    jutils.spectral_norm(jl, n_power_iterations=2)
    tutils.spectral_norm(tl, n_power_iterations=2)
    assert list(tl.state_dict()) == list(jl.state_dict()) == \
        ["bias", "weight_orig", "weight_u", "weight_v"]
    for k in ("weight_u", "weight_v"):
        _close(tl.state_dict()[k].numpy(),
               np.asarray(jl.state_dict()[k]._value), k)
    for s in range(2):                      # training: the iterates move
        _layer_case(jl, tl, [_f(3, 5, seed=s)], tape=True)
    before = tl.state_dict()["weight_u"].clone()
    _layer_case(jl, tl, [_f(3, 5, seed=5)], train=False,   # eval: they stay
                tape=True)
    assert torch.equal(tl.state_dict()["weight_u"], before)
    for k in ("weight_u", "weight_v"):
        _close(tl.state_dict()[k].numpy(),
               np.asarray(jl.state_dict()[k]._value), k)


def test_parameter_vector_round_trip():
    _, tl = _linear_pair()
    vec = tutils.parameters_to_vector(tl.parameters())
    assert isinstance(vec, tp.Tensor) and vec.shape == [18]
    jl, _ = _linear_pair()
    jvec = jutils.parameters_to_vector(jl.parameters())
    _close(vec.numpy(), np.asarray(jvec._value))
    tutils.vector_to_parameters(vec * 2, tl.parameters())
    _close(tl.weight.detach().numpy(),
           2 * np.asarray(jl.weight._value))
    assert tnn.weight_norm is tutils.weight_norm
    assert tnn.remove_weight_norm is tutils.remove_weight_norm
    assert tnn.diag_embed is tF.diag_embed


# -- the dropout family, by statistics ---------------------------------------
def _binomial_ok(kept, n, p_keep, sigmas=5.0):
    return abs(kept - n * p_keep) <= sigmas * np.sqrt(n * p_keep
                                                      * (1 - p_keep))


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_statistics_both_modes(p):
    x = torch.full((200, 100), 2.0)
    tp.seed(0)
    up = tF.dropout(x, p)
    kept = int((up != 0).sum())
    assert _binomial_ok(kept, x.numel(), 1 - p)
    assert torch.allclose(up[up != 0], torch.tensor(2.0 / (1 - p)))
    down = tF.dropout(x, p, mode="downscale_in_infer")
    assert _binomial_ok(int((down != 0).sum()), x.numel(), 1 - p)
    assert torch.equal(down[down != 0], torch.full_like(down[down != 0], 2.))
    # inference: x itself in both modes (JAX's downscale_in_infer is not
    # scaled by 1 - p either)
    for mode in ("upscale_in_train", "downscale_in_infer"):
        assert tF.dropout(x, p, training=False, mode=mode) is x
        j = jF.dropout(jp.to_tensor(x.numpy()), p, training=False, mode=mode)
        np.testing.assert_array_equal(np.asarray(j._value), x.numpy())
    assert torch.equal(tF.dropout(x, 1.0), torch.zeros_like(x))
    with pytest.raises(ValueError, match="mode"):
        tF.dropout(x, p, mode="bogus")


def test_dropout_axis_broadcasts_one_draw():
    x = torch.ones(64, 8, 32)
    tp.seed(1)
    y = tF.dropout(x, 0.5, axis=[0, 2])
    # one mask entry per (i, k), the same along axis 1
    assert torch.equal(y, y[:, :1, :].expand_as(y))
    assert _binomial_ok(int((y[:, 0] != 0).sum()), 64 * 32, 0.5)
    y1 = tF.dropout(x, 0.3, axis=1)
    assert torch.equal(y1, y1[:1, :, :1].expand_as(y1))
    # the JAX package's mask has the same structure
    jy = np.asarray(jF.dropout(jp.to_tensor(x.numpy()), 0.5,
                               axis=[0, 2])._value)
    assert (jy == jy[:, :1, :]).all()
    # dropout2d / dropout3d: whole channels, by data_format
    img = torch.ones(16, 8, 4, 4)
    d2 = tF.dropout2d(img, 0.5)
    assert torch.equal(d2, d2[:, :, :1, :1].expand_as(d2))
    d2n = tF.dropout2d(img, 0.5, data_format="NHWC")
    assert torch.equal(d2n, d2n[:, :1, :1, :].expand_as(d2n))
    d3 = tF.dropout3d(torch.ones(4, 6, 2, 3, 3), 0.5)
    assert torch.equal(d3, d3[:, :, :1, :1, :1].expand_as(d3))


def test_alpha_dropout_keeps_selu_moments():
    x = torch.randn(400, 500, generator=torch.Generator().manual_seed(0))
    y = tF.alpha_dropout(x, 0.2)
    assert abs(float(y.mean())) < 0.02 and abs(float(y.std()) - 1) < 0.02
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    a = (1.0 / ((1 - 0.2) * (1 + 0.2 * alpha_p ** 2))) ** 0.5
    dropped = torch.isclose(y, torch.tensor(a * alpha_p - a * alpha_p * 0.2))
    assert _binomial_ok(int(dropped.sum()), x.numel(), 0.2)
    assert tF.alpha_dropout(x, 0.2, training=False) is x


@pytest.mark.parametrize("cls,shape,kw", [
    ("Dropout2D", (8, 6, 3, 3), {}), ("Dropout3D", (4, 6, 2, 2, 2), {}),
    ("AlphaDropout", (50, 40), {})])
def test_dropout_layers_train_and_eval(cls, shape, kw):
    layer = getattr(tnn, cls)(0.5, **kw)
    x = torch.ones(shape)
    assert not torch.equal(layer(x), x)
    layer.eval()
    assert torch.equal(layer(x), x)


def test_dropout_layer_takes_paddle_arguments():
    """``nn.Dropout(p, axis, mode)`` as in the JAX package (the layer took
    only ``p`` before); the default arguments draw the mask the layer has
    always drawn: ``rand(x.shape) >= p`` from the device's generator."""
    x = torch.randn(32, 16)
    layer = tnn.Dropout(0.25, axis=1, mode="downscale_in_infer")
    assert (layer.p, layer.axis, layer.mode) == (0.25, 1,
                                                 "downscale_in_infer")
    jl = jnn.Dropout(0.25, axis=1, mode="downscale_in_infer")
    assert (jl.p, jl.axis, jl.mode) == (layer.p, layer.axis, layer.mode)
    y = layer(x)
    kept = y != 0
    assert torch.equal(kept, kept[:1].expand_as(kept))
    assert torch.equal(y[kept], x[kept])
    layer.eval()
    assert torch.equal(layer(x), x)
    tp.seed(7)
    got = tnn.Dropout(0.3)(x)
    tp.seed(7)
    keep = torch.rand(x.shape, generator=default_generator(x.device)) >= 0.3
    assert torch.equal(got, torch.where(keep, x / 0.7, torch.zeros_like(x)))
