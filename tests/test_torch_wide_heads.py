"""Head widths past 256 in the port (``paddle_hackathon_tpu_torch``), and
the 3xTF32 operand split of its f32 backward.

- The wrappers' geometry checks of K1, K2 and K3 take every shape the JAX
  package's gates send to those kernels: K1 every (s, H, D) its ``_plan``
  admits (s in {64, 1024}, H in {1, 2, 4}, D a multiple of 8 up to 1024,
  batch 2 and 32769: b * H past 65535),
  K2 any D (its gate reads only the lengths), K3 any D and page size that
  are multiples of 8 (D up to 512).
- The plain paths against the JAX package at D = 320 and 512: the bhd
  forward and gradients in f32, the packed qkv path in bf16 (read in f32),
  paged attention against the JAX decode kernel under the Pallas
  interpreter, and a two-layer GPT of hidden 1024 and 2 heads (D = 512)
  served by both packages' paged engines.
- ``tf32_split``: run through the backward pair's products (each product
  as al.bh + ah.bl + ah.bh, exact in float64, its result rounded to f32 as
  the tensor core's accumulator holds it) it reads within 1e-6 of float64,
  where one TF32 product (ah.bh) reads above 1e-4.

Tolerances: f32 at 1e-5 and bf16 at 1e-2, as the narrower widths' tests
(the same sums in another order; bf16 rounds P and dS at the same points);
paged attention at 2e-5 as ``test_torch_paged_attention.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_hackathon_tpu as paddle
from paddle_hackathon_tpu.inference import ServingEngine as JEngine
from paddle_hackathon_tpu.incubate.nn.kernels import flash_attention as jfa
from paddle_hackathon_tpu.incubate.nn.kernels import \
    flash_attention_packed as jfap
from paddle_hackathon_tpu.incubate.nn.kernels import paged_attention as jpa
from paddle_hackathon_tpu.models.gpt import GPTConfig as JConfig
from paddle_hackathon_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_hackathon_tpu_torch.incubate.nn.functional import \
    flash_attention_qkv_packed
from paddle_hackathon_tpu_torch.incubate.nn.kernels import \
    flash_attention as tfa
from paddle_hackathon_tpu_torch.incubate.nn.kernels import \
    flash_attention_packed as tfap
from paddle_hackathon_tpu_torch.incubate.nn.kernels import \
    paged_attention as tpa
from paddle_hackathon_tpu_torch.inference import ServingEngine
from paddle_hackathon_tpu_torch.models import gpt as tgpt
from paddle_hackathon_tpu_torch.utils import load_jax_state

TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=1e-2, atol=1e-2)}
PAGED_TOL = dict(rtol=2e-5, atol=2e-5)
SEED = 1234


def _f(a):
    return np.asarray(a, np.float32)


# ---------------------------------------------------------------------------
# The geometry checks take what the JAX gates admit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b", [2, 32769])
@pytest.mark.parametrize("s", [64, 1024])
@pytest.mark.parametrize("heads", [1, 2, 4])
def test_k1_geometry_takes_every_jax_plan(s, heads, b):
    # b = 32769 puts b * H past 65535 (a grid's y limit) at H >= 2: every
    # K1 kernel folds its (rows, head, batch) items into grid.x
    admitted = 0
    for d in range(8, 1025, 8):
        for jd, td in ((jnp.bfloat16, torch.bfloat16),
                       (jnp.float16, torch.float16)):
            ok = jfap.supported(s, s, heads, d, jd)
            assert tfap.supported(s, s, heads, d, td) == ok, (s, heads, d)
            if ok:
                tfap.check_geometry((b, s, 3 * heads * d), heads, td)
                admitted += d > 256
    assert admitted > 0           # the JAX plan reaches past 256 here


@pytest.mark.parametrize("dt", ["float32", "bfloat16", "float16"])
def test_k2_geometry_takes_any_head_dim(dt):
    widths = sorted(set(range(1, 1025, 13)) | {256, 257, 264, 320, 512,
                                               1023, 1024})
    for sq, skv in ((1024, 1024), (256, 1024), (40, 40)):
        assert jfa.supported(sq, skv) and tfa.supported(sq, skv)
        for d in widths:
            tfa.check_geometry((3, sq, d), (3, skv, d), getattr(torch, dt))


@pytest.mark.parametrize("dt", ["float32", "bfloat16", "float16"])
def test_k3_geometry_takes_every_jax_width(dt):
    for page in (8, 16, 128):
        for d in range(8, 513, 8):
            assert jpa.supported(page, d)
            pool = (5, page, 2, d)
            tpa.check_geometry((2, 3, 2, d), (pool, pool),
                               (getattr(torch, dt),) * 3, (2, 4), torch.int32,
                               (2,), torch.int32)


# ---------------------------------------------------------------------------
# The plain paths against the JAX package at D = 320 and 512
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [320, 512])
def test_bhd_f32_wide_heads_match_jax_kernel(d):
    rng = np.random.RandomState(d)
    q, k, v, do = (rng.randn(2, s, d).astype(np.float32)
                   for s in (64, 128, 128, 64))
    sc = 1.0 / np.sqrt(d)
    jargs = [jnp.asarray(x) for x in (q, k, v)]
    jseed = jnp.asarray([SEED], jnp.int32)
    j_out, j_lse = jfa._fwd(*jargs, True, sc, 0.0, jseed)
    j_grads = jax.grad(lambda a, b, c: jnp.sum(jfa.flash_attention_bhd(
        a, b, c, True, sc) * do), argnums=(0, 1, 2))(*jargs)
    targs = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    t_out, t_lse = tfa._fwd(*(t.detach() for t in targs), True, sc)
    np.testing.assert_allclose(t_out.numpy(), _f(j_out), **TOL["f32"])
    np.testing.assert_allclose(t_lse.numpy(), _f(j_lse)[:, 0, :],
                               **TOL["f32"])
    out = tfa.flash_attention_bhd(*targs, True, sc)
    (out * torch.from_numpy(do)).sum().backward()
    for name, t, j in zip("qkv", targs, j_grads):
        np.testing.assert_allclose(t.grad.numpy(), _f(j), err_msg=f"d{name}",
                                   **TOL["f32"])


@pytest.mark.parametrize("heads,d", [(2, 320), (1, 512)])
def test_qkv_packed_wide_heads_match_jax_kernel(heads, d):
    rng = np.random.RandomState(d)
    s = 64
    x = (rng.randn(1, s, 3 * heads * d) * 0.5).astype(np.float32)
    cot = rng.randn(1, s, heads * d).astype(np.float32)
    assert jfap.supported(s, s, heads, d, jnp.bfloat16)
    sc = 1.0 / np.sqrt(d)
    jx = jnp.asarray(x, jnp.bfloat16)
    j_out = jfap.flash_attention_packed(jx, heads, True, sc)
    j_grad = jax.grad(lambda a: jnp.sum(jfap.flash_attention_packed(
        a, heads, True, sc).astype(jnp.float32) * cot))(jx)
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    out = flash_attention_qkv_packed(tx, heads)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.detach().float().numpy(), _f(j_out),
                               **TOL["bf16"])
    (out.float() * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(tx.grad.float().numpy(), _f(j_grad),
                               **TOL["bf16"])


@pytest.mark.parametrize("d,width", [(320, 1), (512, 1), (512, 4)])
def test_paged_attention_wide_heads_match_jax_kernel(d, width):
    rng = np.random.RandomState(d + width)
    B, P, H, maxp = 2, 8, 2, 3
    N = 1 + B * maxp
    case = dict(q=rng.randn(B, width, H, d).astype(np.float32),
                k_pool=rng.randn(N, P, H, d).astype(np.float32),
                v_pool=rng.randn(N, P, H, d).astype(np.float32),
                page_table=(rng.permutation(N - 1) + 1).reshape(B, maxp)
                .astype(np.int32),
                lengths=np.asarray([5, 17], np.int32))
    got = tpa.paged_attention(**{k: torch.from_numpy(v.copy())
                                 for k, v in case.items()})
    jcase = {k: jnp.asarray(v) for k, v in case.items()}
    # width 1: the Pallas decode kernel under the interpreter; wider: the
    # JAX reference, where the JAX dispatcher sends it
    jfn = jpa.paged_attention_decode if width == 1 else jpa.paged_attention_ref
    np.testing.assert_allclose(got.numpy(), _f(jfn(**jcase)), **PAGED_TOL)


def test_wide_gpt_paged_engine_token_exact_vs_jax_engine():
    """A two-layer GPT of hidden 1024 and 2 heads (D = 512) on shared
    weights: the port's paged engine against the JAX package's."""
    cfg = dict(vocab_size=128, hidden_size=1024, num_layers=2, num_heads=2,
               max_position_embeddings=64, hidden_dropout_prob=0.0,
               attention_dropout_prob=0.0, use_flash_attention=False)
    engine = dict(max_slots=2, max_len=32, chunk=4, cache_mode="paged",
                  page_size=8)
    paddle.seed(11)
    jm = JGPT(JConfig(**cfg))
    jm.eval()
    arrays = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**cfg), device="cpu")
    load_jax_state(tm, arrays)
    rs = np.random.RandomState(5)
    prompts = [rs.randint(0, 128, (n,)).astype(np.int32) for n in (6, 11)]
    jeng = JEngine(jm, auto_run=False, **engine)
    jreqs = [jeng.submit(p, 6) for p in prompts]
    jeng.run_until_idle()
    want = [np.asarray(r.result()) for r in jreqs]
    jeng.shutdown()
    teng = ServingEngine(tm, auto_run=False, **engine)
    treqs = [teng.submit(p, 6) for p in prompts]
    teng.run_until_idle()
    got = [np.asarray(r.result()) for r in treqs]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# The 3xTF32 split of the f32 backward
# ---------------------------------------------------------------------------

def _split_product(eq, a, b, terms):
    """einsum(eq, a, b) from split f32 operands, exact in float64 and
    rounded to f32: terms 3 is al.bh + ah.bl + ah.bh, terms 1 ah.bh."""
    ah, al = tfa.tf32_split(a)
    bh, bl = tfa.tf32_split(b)
    e = lambda x, y: torch.einsum(eq, x.double(), y.double())  # noqa: E731
    out = e(ah, bh) if terms == 1 else e(al, bh) + e(ah, bl) + e(ah, bh)
    return out.float()


def _split_bwd_pair(q, k, v, do, lse, delta, sm_scale, terms):
    """``flash_bwd_pair_ref``'s causal backward with every product taken
    from split operands: P, dP and dS in f32 between the products, as the
    kernels hold them."""
    sq, skv = q.shape[1], k.shape[1]
    mask = torch.ones(sq, skv, dtype=torch.bool).tril()
    s = _split_product("bqd,bkd->bqk", q, k, terms) * sm_scale
    p = torch.exp(s - lse[..., None]).masked_fill(~mask, 0.0)
    dp = _split_product("bqd,bkd->bqk", do, v, terms)
    dv = _split_product("bqk,bqd->bkd", p, do, terms)
    ds = p * (dp - delta[..., None]) * sm_scale
    dk = _split_product("bqk,bqd->bkd", ds, q, terms)
    dq = _split_product("bqk,bkd->bqd", ds, k, terms)
    return dq, dk, dv


def test_tf32_split_is_round_to_nearest():
    """hi keeps 10 mantissa bits, ties away from zero (cvt.rna); lo is
    the same rounding of the rest, so hi + lo is x to 2^-22."""
    x = torch.tensor([1.0 + 2**-11, 1.0 + 3 * 2**-11, -(1.0 + 2**-11),
                      1.0 + 2**-11 - 2**-23, 0.1, -3.7e5])
    hi, lo = tfa.tf32_split(x)
    assert hi.tolist()[:4] == [1.0 + 2**-10, 1.0 + 2**-9, -(1.0 + 2**-10),
                               1.0]
    assert int((hi.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert int((lo.view(torch.int32) & 0x1FFF).abs().max()) == 0
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2.0**-22 * x.double().abs()).all())


@pytest.mark.parametrize("d", [64, 256])
def test_tf32_split_products_hold_f32_accuracy(d):
    rng = np.random.RandomState(d)
    bh, s = 2, 128
    q, k = ((rng.randn(bh, s, d) * 0.5).astype(np.float32) for _ in "qk")
    v, do = (rng.randn(bh, s, d).astype(np.float32) for _ in "vd")
    q, k, v, do = (torch.from_numpy(x) for x in (q, k, v, do))
    sc = 1.0 / np.sqrt(d)
    o64, lse64 = tfa.flash_fwd_ref(q.double(), k.double(), v.double(), True,
                                   sc)
    delta64 = (do.double() * o64).sum(-1)
    ref = tfa.flash_bwd_pair_ref(q.double(), k.double(), v.double(),
                                 do.double(), lse64, delta64, True, sc)
    rel = lambda got, want: float(  # noqa: E731
        (got.double() - want).norm() / want.norm())
    lse, delta = lse64.float(), delta64.float()
    three = _split_bwd_pair(q, k, v, do, lse, delta, sc, terms=3)
    one = _split_bwd_pair(q, k, v, do, lse, delta, sc, terms=1)
    for name, t3, t1, r in zip(("dq", "dk", "dv"), three, one, ref):
        assert rel(t3, r) <= 1e-6, (name, rel(t3, r))
        assert rel(t1, r) > 1e-4, (name, rel(t1, r))
