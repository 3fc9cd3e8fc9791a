"""The port's Transformer layers (``nn/layers/transformer.py``) against
the JAX package, on the JAX layers' weights (``load_jax_state``):

- ``MultiHeadAttention`` with and without an additive mask, with a
  growing ``Cache`` and a ``StaticCache`` (cross attention's memory),
  kdim / vdim apart from embed_dim, outputs and gradients (the JAX side
  through its ``functional_call`` under one ``jax.jit`` of ``jax.vjp``);
- ``TransformerEncoder``, ``TransformerDecoder`` and ``Transformer``
  with ``normalize_before`` off and on (one JAX model of each setting,
  shared across the file's cases), forward and the gradients of every
  parameter;
- incremental decoding: the decoder fed one target row at a time
  through ``gen_cache``'s caches equals its full forward under the
  causal mask, row for row;
- the SDPA dispatch: where the JAX package's
  ``scaled_dot_product_attention`` tries the bhd flash kernels (K2) and
  their gate takes the lengths, the port's does too, across the flag,
  ``use_flash``, the mask and the length;
- sequence parallelism raises citing ROADMAP item 12.

f32 at rtol 1e-5 / atol 1e-6; the gradients of the encoder and
decoder stacks at rtol 2e-5 and an atol of 1e-6 times the largest entry
of that gradient (four layer norms and two attention softmaxes deep, the
two libraries' f32 reductions drift by a few ulps of the largest entries:
1.8e-6 on a bias gradient whose largest entry is 2.65).
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
from paddle_hackathon_tpu.incubate.nn import functional as jinc
from paddle_hackathon_tpu.incubate.nn.kernels import flash_attention as jfa
from paddle_hackathon_tpu.nn import functional as jF
from paddle_hackathon_tpu.nn.layer import functional_call as jfcall
from paddle_hackathon_tpu_torch import nn as tnn
from paddle_hackathon_tpu_torch.incubate.nn.kernels import \
    flash_attention as tfa
from paddle_hackathon_tpu_torch.nn.functional import attention as tattn
from paddle_hackathon_tpu_torch.utils import load_jax_state

RTOL, ATOL = 1e-5, 1e-6
STACK_RTOL = 2e-5
D, H, FF = 16, 4, 32


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")
    yield


def _f(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, want, what="", rtol=RTOL, scaled=False):
    want = np.asarray(want)
    atol = ATOL * max(1.0, float(np.abs(want).max())) if scaled else ATOL
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=atol,
                               err_msg=what)


def _pair(build):
    """The same layer in both packages, the port's on the JAX weights."""
    jp.seed(11)
    jl, tl = build(jnn), build(tnn)
    load_jax_state(tl, {k: np.asarray(v._value)
                        for k, v in jl.state_dict().items()})
    jl.eval(), tl.eval()
    return jl, tl


def _both(jl, tl, args, kwargs=None, flt=(), rtol=RTOL):
    """Run the layer in both packages on numpy ``args`` / ``kwargs`` and
    compare the output and the gradients of ``sum(out * cot)`` to
    ``args[flt]`` and to every parameter.  The JAX side is its
    ``functional_call`` under one ``jax.jit`` of ``jax.vjp``."""
    kwargs = kwargs or {}
    params = {k: v._value for k, v in jl.named_parameters()}
    cot = None

    def f(xs, ps):
        a = list(args)
        for i, x in zip(flt, xs):
            a[i] = x
        return jfcall(jl, ps, tuple(JTensor(jnp.asarray(v)) for v in a),
                      kwargs={k: JTensor(jnp.asarray(v))
                              for k, v in kwargs.items()})

    @jax.jit
    def jboth(xs, ps):
        out, vjp = jax.vjp(f, xs, ps)
        return out, vjp(jnp.asarray(_f(*out.shape, seed=42)))
    jout, (jgx, jgp) = jboth([jnp.asarray(args[i]) for i in flt], params)
    tin = [torch.tensor(a, requires_grad=i in flt)
           for i, a in enumerate(args)]
    tout = tl(*tin, **{k: torch.tensor(v) for k, v in kwargs.items()})
    _close(tout.detach().numpy(), jout)
    cot = _f(*tout.shape, seed=42)
    names = [n for n, _ in tl.named_parameters()]
    tparams = dict(tl.named_parameters())
    g = torch.autograd.grad((tout * torch.from_numpy(cot)).sum(),
                            [tin[i] for i in flt]
                            + [tparams[n] for n in names])
    scaled = rtol != RTOL
    for t, j in zip(g, jgx):
        _close(t.numpy(), j, "input", rtol, scaled)
    for n, t in zip(names, g[len(flt):]):
        _close(t.numpy(), jgp[n], n, rtol, scaled)


def _mask(sq, skv, seed):
    m = np.zeros((1, 1, sq, skv), np.float32)
    m[..., np.random.RandomState(seed).rand(sq, skv) < 0.3] = -1e30
    m[..., 0] = 0.0                       # every row keeps a key
    return m


@pytest.mark.parametrize("masked", [False, True])
def test_multi_head_attention_matches_jax(masked):
    jl, tl = _pair(lambda nn: nn.MultiHeadAttention(D, H, kdim=12, vdim=10))
    q, k, v = _f(2, 5, D), _f(2, 7, 12, seed=1), _f(2, 7, 10, seed=2)
    kw = {"attn_mask": _mask(5, 7, 3)} if masked else {}
    _both(jl, tl, [q, k, v], kw, flt=(0, 1, 2))


def test_multi_head_attention_caches_match_jax():
    jl, tl = _pair(lambda nn: nn.MultiHeadAttention(D, H))
    mem = _f(2, 6, D, seed=4)
    # StaticCache: cross attention against a fixed memory
    jsc = jl.gen_cache(jp.to_tensor(mem), jp.to_tensor(mem),
                       type=jnn.MultiHeadAttention.StaticCache)
    tsc = tl.gen_cache(tp.to_tensor(mem), tp.to_tensor(mem),
                       type=tnn.MultiHeadAttention.StaticCache)
    assert isinstance(tsc, tnn.MultiHeadAttention.StaticCache)
    x = _f(2, 3, D, seed=5)
    _close(tl(tp.to_tensor(x), cache=tsc).numpy(),
           jl(jp.to_tensor(x), cache=jsc)._value)
    _close(tl(torch.tensor(x), torch.tensor(mem), torch.tensor(mem))
           .detach().numpy(), jl(jp.to_tensor(x), jp.to_tensor(mem),
                                 jp.to_tensor(mem))._value)
    # Cache: grows by each call's rows
    jc = jl.gen_cache(jp.to_tensor(x))
    tc = tl.gen_cache(tp.to_tensor(x))
    assert tuple(tc.k.shape) == (2, 0, H, D // H)
    for i in range(3):
        step = _f(2, 1, D, seed=10 + i)
        jo, jc = jl(jp.to_tensor(step), cache=jc)
        to, tc = tl(tp.to_tensor(step), cache=tc)
        assert isinstance(tc, tnn.MultiHeadAttention.Cache)
        _close(to.numpy(), jo._value, f"step {i}")
        _close(tc.k.numpy(), jc.k._value)
        _close(tc.v.numpy(), jc.v._value)
    assert tc.k.shape == [2, 3, H, D // H]


def _transformer(nn, before):
    return nn.Transformer(d_model=D, nhead=H, num_encoder_layers=2,
                          num_decoder_layers=2, dim_feedforward=FF,
                          dropout=0.0, normalize_before=before)


@pytest.fixture(scope="module", params=[False, True],
                ids=["post_ln", "pre_ln"])
def models(request):
    tp.set_device("cpu")
    return _pair(lambda nn: _transformer(nn, request.param))


def test_encoder_matches_jax(models):
    jm, tm = models
    _both(jm.encoder, tm.encoder, [_f(2, 6, D, seed=1), _mask(6, 6, 5)],
          flt=(0,), rtol=STACK_RTOL)


def test_transformer_and_decoder_match_jax(models):
    jm, tm = models
    src, tgt = _f(2, 6, D, seed=2), _f(2, 4, D, seed=3)
    tgt_mask = jnn.Transformer.generate_square_subsequent_mask(4)
    tmask = tnn.Transformer.generate_square_subsequent_mask(4)
    assert isinstance(tmask, tp.Tensor)
    _close(tmask.numpy(), tgt_mask._value)
    _both(jm, tm, [src, tgt], {"tgt_mask": tmask.numpy()}, flt=(0, 1),
          rtol=STACK_RTOL)


def test_incremental_decoding_equals_full_forward(models):
    """The decoder over ``gen_cache``'s caches (a growing self-attention
    ``Cache`` and the memory's ``StaticCache`` a layer), one target row a
    call, row for row against the full causal forward; and the JAX
    package's incremental rows against the port's."""
    jm, tm = models
    src, tgt = _f(2, 5, D, seed=6), _f(2, 4, D, seed=7)
    mem_t = tm.encoder(torch.tensor(src))
    mem_j = jm.encoder(jp.to_tensor(src))
    full = tm.decoder(torch.tensor(tgt), mem_t,
                      tnn.Transformer.generate_square_subsequent_mask(4)
                      ._value).detach()
    tcache = tm.decoder.gen_cache(mem_t)
    jcache = jm.decoder.gen_cache(mem_j)
    for i in range(4):
        row = tgt[:, i:i + 1]
        to, tcache = tm.decoder(torch.tensor(row), mem_t, cache=tcache)
        jo, jcache = jm.decoder(jp.to_tensor(row), mem_j, cache=jcache)
        _close(to.detach().numpy(), full[:, i:i + 1].numpy(), f"row {i}")
        _close(to.detach().numpy(), jo._value, f"row {i} vs JAX")
    assert tcache[0][0].k.shape[1] == 4
    # the encoder's caches work the same way (each layer's self-attention
    # grows by the rows fed)
    enc_cache = tm.encoder.gen_cache(torch.tensor(src))
    out, enc_cache = tm.encoder(torch.tensor(src), cache=enc_cache)
    _close(out.detach().numpy(), mem_t.detach().numpy())
    assert enc_cache[0].k.shape[1] == 5


def _flash_spy(monkeypatch, module, gate):
    """Replace ``module.flash_attention_bshd`` with a recorder: each call
    records whether the kernels' gate takes the lengths, then raises the
    gate's ``ValueError`` so the plain composition runs (no kernel is
    launched on either side)."""
    calls = []

    def spy(q, k, v, causal=False, sm_scale=None, dropout_p=0.0, seed=None):
        calls.append(bool(gate(q.shape[1], k.shape[1])))
        raise ValueError("spy")
    monkeypatch.setattr(module, "flash_attention_bshd", spy)
    return calls


@pytest.mark.parametrize("fused,min_seqlen", [(True, 8), (True, 1024),
                                              (False, 8)])
def test_sdpa_dispatch_matches_jax(monkeypatch, fused, min_seqlen):
    jcalls = _flash_spy(monkeypatch, jinc, jfa.supported)
    tcalls = _flash_spy(monkeypatch, tattn, tfa.supported)
    old = (jp.get_flags(["use_fused_kernels", "flash_attention_min_seqlen"]),
           tp.get_flags(["use_fused_kernels", "flash_attention_min_seqlen"]))
    flags = {"use_fused_kernels": fused,
             "flash_attention_min_seqlen": min_seqlen}
    jp.set_flags(flags), tp.set_flags(flags)
    try:
        jl, tl = _pair(lambda nn: nn.MultiHeadAttention(D, H))
        decisions = []
        for s in (8, 12):
            for masked in (False, True):
                x = _f(1, s, D, seed=s)
                mask = _mask(s, s, s) if masked else None
                n_j, n_t = len(jcalls), len(tcalls)
                jo = jl(jp.to_tensor(x), attn_mask=None if mask is None
                        else jp.to_tensor(mask))
                to = tl(torch.tensor(x), attn_mask=None if mask is None
                        else torch.tensor(mask))
                _close(to.detach().numpy(), jo._value)
                decisions.append((jcalls[n_j:], tcalls[n_t:]))
                # the functional with an explicit use_flash, both ways
                for use in (True, False):
                    q = _f(1, s, H, D // H, seed=s + 1)
                    jF.scaled_dot_product_attention(
                        *[jp.to_tensor(q)] * 3, use_flash=use)
                    tattn.scaled_dot_product_attention(
                        *[torch.tensor(q)] * 3, use_flash=use)
        assert jcalls == tcalls
        for j, t in decisions:
            assert j == t
    finally:
        jp.set_flags(old[0]), tp.set_flags(old[1])
    if fused and min_seqlen == 8:
        assert True in tcalls and False in tcalls   # both gate answers seen


def test_sequence_parallel_raises_citing_item_12():
    tl = tnn.MultiHeadAttention(D, H, device="cpu")
    assert tl.supports_sequence_parallel and not tl._sp_enabled()
    tl.seq_parallel_axis = "sp"
    assert tl._sp_enabled()
    x = torch.tensor(_f(1, 4, D))
    with pytest.raises(NotImplementedError, match="item 12"):
        tl(x)
    with pytest.raises(ValueError, match="sequence parallelism"):
        tl(x, attn_mask=torch.zeros(1, 1, 4, 4))
