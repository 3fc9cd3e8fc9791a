"""The port's GPT (``paddle_hackathon_tpu_torch.models.gpt``) against the
JAX package's on shared weights: the tiny GPT of ``test_paged.py`` (vocab
128, hidden 64, 2 layers, 4 heads, f32, dropout 0) is built in JAX, its
``state_dict()`` exported to numpy and loaded name for name into the
port.  Logits of the no-cache, static-cache, growing-cache and paged
forwards agree at ``atol=1e-5`` (f32, the same products summed in other
orders); greedy ``generate`` is token-exact, with either
``jit_decode``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_hackathon_tpu as paddle
from paddle_hackathon_tpu.core.tensor import Tensor
from paddle_hackathon_tpu.models.gpt import GPTConfig as JConfig
from paddle_hackathon_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_hackathon_tpu_torch.models import gpt as tgpt
from paddle_hackathon_tpu_torch.utils import load_jax_state
from paddle_hackathon_tpu_torch.utils.convert import to_tensor

ATOL = 1e-5
_CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            max_position_embeddings=128, hidden_dropout_prob=0.0,
            attention_dropout_prob=0.0, use_flash_attention=False)


@pytest.fixture(scope="module")
def models():
    paddle.seed(3)
    jm = JGPT(JConfig(**_CFG))
    jm.eval()
    arrays = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**_CFG), device="cpu")
    load_jax_state(tm, arrays)
    return jm, tm


def _ids(shape, seed=0):
    return np.random.RandomState(seed).randint(0, 128, shape).astype(
        np.int32)


def _np(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def test_no_cache_logits_match_jax(models):
    jm, tm = models
    ids = _ids((2, 11))
    ref = _np(jm(Tensor(jnp.asarray(ids))))
    with torch.no_grad():
        out = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


def _zeros_caches(shape):
    return ([(jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32))
             for _ in range(2)],
            [(torch.zeros(shape), torch.zeros(shape)) for _ in range(2)])


def test_static_cache_forward_matches_jax(models):
    """Prefill at a scalar offset, then a per-slot step at ragged offsets
    (the dense engine's tick), logits and cache rows both."""
    jm, tm = models
    B, T = 2, 24
    jc, tc = _zeros_caches((B, T, 4, 16))
    ids = _ids((B, 7), 1)
    jl, jc = jm(Tensor(jnp.asarray(ids)), caches=jc,
                cache_pos=jnp.asarray(0, jnp.int32))
    with torch.no_grad():
        tl, tc = tm(torch.from_numpy(ids), caches=tc,
                    cache_pos=torch.tensor(0, dtype=torch.int32))
    np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=0, atol=ATOL)
    pos = np.asarray([7, 3], np.int32)
    step = _ids((B, 2), 2)
    jl, jc = jm(Tensor(jnp.asarray(step)), caches=jc,
                cache_pos=jnp.asarray(pos))
    with torch.no_grad():
        tl, tc = tm(torch.from_numpy(step), caches=tc,
                    cache_pos=torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=0, atol=ATOL)
    for (jk, jv), (tk, tv) in zip(jc, tc):
        np.testing.assert_allclose(tk.numpy(), _np(jk), rtol=0, atol=ATOL)
        np.testing.assert_allclose(tv.numpy(), _np(jv), rtol=0, atol=ATOL)


def test_paged_forward_matches_jax(models):
    """A chunk then a width-1 step through shuffled page tables, with an
    inactive slot on the NULL page and a write straddling a page
    boundary."""
    jm, tm = models
    P, maxp, B = 8, 3, 3
    N = 1 + B * maxp
    pt = (np.random.RandomState(4).permutation(N - 1) + 1).reshape(
        B, maxp).astype(np.int32)
    pt[2] = 0                                   # inactive slot
    jc, tc = _zeros_caches((N, P, 4, 16))
    for ids, pos in ((_ids((B, 5), 5), [0, 6, 0]),
                     (_ids((B, 1), 6), [5, 11, 0])):
        pos = np.asarray(pos, np.int32)
        jl, jc = jm(Tensor(jnp.asarray(ids)), caches=jc,
                    cache_pos=jnp.asarray(pos), page_table=jnp.asarray(pt))
        with torch.no_grad():
            tl, tc = tm(torch.from_numpy(ids), caches=tc,
                        cache_pos=torch.from_numpy(pos),
                        page_table=torch.from_numpy(pt))
        np.testing.assert_allclose(tl[:2].numpy(), _np(jl)[:2], rtol=0,
                                   atol=ATOL)
    for (jk, _), (tk, _) in zip(jc, tc):
        # page 0 is scratch (the inactive slot's rows): compare live pages
        np.testing.assert_allclose(tk[1:].numpy(), _np(jk)[1:], rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("prompt_len,new", [(5, 8), (9, 6)])
def test_greedy_generate_is_token_exact_vs_jax(models, prompt_len, new):
    jm, tm = models
    ids = _ids((2, prompt_len), prompt_len)
    ref = _np(jm.generate(Tensor(jnp.asarray(ids)), max_new_tokens=new,
                          temperature=0.0))
    out = tm.generate(ids, max_new_tokens=new, temperature=0.0).numpy()
    np.testing.assert_array_equal(out, ref)


def test_sampling_filters_match_jax():
    """The top-k and nucleus masks and the vector-mode greedy rows."""
    rng = np.random.RandomState(8)
    logits = rng.randn(4, 32).astype(np.float32) * 3
    t = torch.from_numpy(logits)
    np.testing.assert_allclose(
        tgpt.GPTForCausalLM._nucleus_mask(t, 0.7).numpy(),
        np.asarray(JGPT._nucleus_mask(jnp.asarray(logits), 0.7)), rtol=1e-6)
    temps = np.asarray([0.0, 0.0, 0.0, 0.0], np.float32)
    topk = np.asarray([0, 3, 0, 5], np.int32)
    topp = np.asarray([1.0, 1.0, 0.5, 0.9], np.float32)
    ref = np.asarray(JGPT._sample(jnp.asarray(logits), jnp.asarray(temps),
                                  jnp.asarray(topk), top_p=jnp.asarray(topp)))
    out = tgpt.GPTForCausalLM._sample(
        t, torch.from_numpy(temps), torch.from_numpy(topk),
        top_p=torch.from_numpy(topp)).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(
        tgpt.GPTForCausalLM._sample(t, 0.0, 4).numpy(),
        np.asarray(JGPT._sample(jnp.asarray(logits), 0.0, 4)))


def test_temperature_sampling_follows_its_generator(models):
    _, tm = models
    ids = _ids((1, 6), 9)
    runs = [tm.generate(ids, 8, temperature=1.0, top_k=20,
                        generator=torch.Generator().manual_seed(11))
            for _ in range(2)]
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
    assert ((runs[0] >= 0) & (runs[0] < 128)).all()


def test_cache_pos_decides_positions_over_position_ids(models):
    """The reference's rule: with a cache, positions come from
    ``cache_pos`` even where ``position_ids`` is passed beside it."""
    jm, tm = models
    B, T = 2, 24
    jc, tc = _zeros_caches((B, T, 4, 16))
    ids = _ids((B, 5), 12)
    pos = np.asarray([3, 9], np.int32)
    stray = np.zeros((B, 5), np.int32)          # not the cache positions
    jl, _ = jm(Tensor(jnp.asarray(ids)), Tensor(jnp.asarray(stray)),
               caches=jc, cache_pos=jnp.asarray(pos))
    with torch.no_grad():
        tl, _ = tm(torch.from_numpy(ids), torch.from_numpy(stray).long(),
                   caches=tc, cache_pos=torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=0, atol=ATOL)


def test_generate_fifth_positional_is_jit_decode(models):
    """``generate(ids, n, 1.0, None, False)`` means ``jit_decode=False`` as
    in the reference: it samples (the same draws as the keyword call) and
    does not decode greedily."""
    _, tm = models
    ids = _ids((2, 6), 13)
    gen = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    positional = tm.generate(ids, 12, 1.0, None, False, generator=gen())
    keyword = tm.generate(ids, 12, temperature=1.0, generator=gen())
    greedy = tm.generate(ids, 12, temperature=0.0)
    torch.testing.assert_close(positional, keyword, rtol=0, atol=0)
    assert not torch.equal(positional, greedy)
    # the seventh and eighth positionals are spec_k and drafter: a drafter
    # without spec_k is ignored, as in the reference, and spec_k decodes
    # the same greedy tokens
    short = tm.generate(ids, 2, temperature=0.0)
    for spec_k in (0, 2):
        torch.testing.assert_close(
            tm.generate(ids, 2, 0.0, None, True, None, spec_k, "ngram"),
            short, rtol=0, atol=0)


def test_load_jax_state_rejects_mismatches(models):
    jm, _ = models
    arrays = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**_CFG), device="cpu")
    missing = dict(arrays)
    missing.pop("gpt.ln_f.bias")
    with pytest.raises(KeyError, match="ln_f.bias"):
        load_jax_state(tm, missing)
    extra = dict(arrays, **{"gpt.extra.weight": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="extra"):
        load_jax_state(tm, extra)
    bad = dict(arrays)
    bad["gpt.wpe.weight"] = bad["gpt.wpe.weight"].T
    with pytest.raises(ValueError, match="wpe"):
        load_jax_state(tm, bad)


def test_bf16_arrays_from_jax_keep_their_bits():
    vals = jnp.asarray(np.random.RandomState(0).randn(5, 3), jnp.bfloat16)
    arr = np.asarray(vals)
    assert arr.dtype.name == "bfloat16"
    t = to_tensor(arr)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  arr.view(np.int16))


def test_model_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tgpt.GPTForCausalLM(tgpt.GPTConfig(**_CFG))


@pytest.mark.parametrize("s", [4, 8])
def test_forced_flash_matches_jax(models, s):
    """Flash forced in f32, where the packed kernels refuse the dtype:
    neither flash kernel takes s=4, so both packages run the plain
    composition; at s=8 both take the bhd kernels (K2) through
    scaled_dot_product_attention, JAX's under the Pallas interpreter and
    the port's plain version on the CPU."""
    jm, _ = models
    arrays = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    cfg = tgpt.GPTConfig(**dict(_CFG, use_flash_attention=True))
    tm = load_jax_state(tgpt.GPTForCausalLM(cfg, device="cpu"), arrays)
    ids = _ids((1, s), s)
    attns = [blk.attn for blk in jm.gpt.blocks]
    for a in attns:
        a.use_flash = True
    try:
        ref = _np(jm(Tensor(jnp.asarray(ids))))
    finally:
        for a in attns:
            a.use_flash = False
    with torch.no_grad():
        out = tm(torch.from_numpy(ids)).numpy()
    assert out.shape == (1, s, 128)
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


def test_flash_dispatch_reads_the_flags():
    """Auto mode (use_flash_attention=None) takes the packed kernels from
    flash_attention_min_seqlen on, and never with use_fused_kernels off;
    the flags start at the JAX package's defaults."""
    from paddle_hackathon_tpu_torch.core import flags
    assert flags.flag("flash_attention_min_seqlen") == 1024
    assert flags.flag("use_fused_kernels") is True
    cfg = tgpt.GPTConfig(**dict(_CFG, hidden_size=128, num_heads=2,
                                use_flash_attention=None))
    attn = tgpt.GPTAttention(cfg, device="cpu")
    qkv = torch.zeros(1, 128, 384, dtype=torch.bfloat16)
    assert not attn._packed_flash_ok(qkv, 128)
    try:
        flags.set_flags({"FLAGS_flash_attention_min_seqlen": 128})
        assert attn._packed_flash_ok(qkv, 128)
        assert not attn._packed_flash_ok(qkv.float(), 128)
        flags.set_flags({"use_fused_kernels": False})
        assert not attn._packed_flash_ok(qkv, 128)
        with pytest.raises(ValueError, match="unknown flag"):
            flags.set_flags({"no_such_flag": 1})
    finally:
        flags.set_flags({"flash_attention_min_seqlen": 1024,
                         "use_fused_kernels": True})


def test_presets():
    cfg = tgpt.gpt_config("gpt2-small-en", hidden_dropout_prob=0.0)
    assert (cfg.num_layers, cfg.hidden_size, cfg.num_heads) == (12, 768, 12)
    assert cfg.vocab_size == 50304 and cfg.hidden_dropout_prob == 0.0


def test_growing_cache_forward_matches_jax(models):
    """``caches`` without ``cache_pos``, from ``gen_empty_caches``: a
    prefill, a chunked prefill (the additive mask of its past length) and
    three decode rows, each step's logits and the grown caches against the
    JAX package's; positions come from the past length."""
    jm, tm = models
    B = 2
    jc = jm.gpt.gen_empty_caches(B)
    tc = tm.gpt.gen_empty_caches(B)
    assert [tuple(k.shape) for k, _ in tc] == [(B, 0, 4, 16)] * 2
    steps = [_ids((B, 6), 20), _ids((B, 4), 21)] + \
        [_ids((B, 1), 22 + i) for i in range(3)]
    for step in steps:
        jl, jc = jm(Tensor(jnp.asarray(step)), caches=jc)
        with torch.no_grad():
            tl, tc = tm(torch.from_numpy(step), caches=tc)
        np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=0, atol=ATOL)
    for (jk, jv), (tk, tv) in zip(jc, tc):
        assert tk.shape == (B, 13, 4, 16)
        np.testing.assert_allclose(tk.numpy(), _np(jk), rtol=0, atol=ATOL)
        np.testing.assert_allclose(tv.numpy(), _np(jv), rtol=0, atol=ATOL)


@pytest.mark.parametrize("prompt_len,new", [(5, 8), (9, 6)])
def test_greedy_generate_jit_decode_false_is_token_exact_vs_jax(
        models, prompt_len, new):
    """``generate(jit_decode=False)`` token-exact against the reference's
    eager loop over its growing cache, and the same tokens as
    ``jit_decode=True``."""
    jm, tm = models
    ids = _ids((2, prompt_len), 40 + prompt_len)
    ref = _np(jm.generate(Tensor(jnp.asarray(ids)), max_new_tokens=new,
                          temperature=0.0, jit_decode=False))
    out = tm.generate(ids, max_new_tokens=new, temperature=0.0,
                      jit_decode=False).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(
        tm.generate(ids, max_new_tokens=new, temperature=0.0).numpy(), ref)
