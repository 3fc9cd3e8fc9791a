"""The port's speculative decoding and beam search
(``paddle_hackathon_tpu_torch/nn/decode.py``, ``GPTForCausalLM.generate``
with ``spec_k``, the serving engine's verify tick) against the JAX
package's, on the 2-layer f32 GPT of ``tests/test_spec_decode.py`` with
the JAX weights carried across by ``load_jax_state``.

Tolerances: tokens, draft proposals, acceptance lengths and spec
counters are held exactly (greedy decoding on shared f32 weights);
beam-search log-probs within 1e-5 absolute (f32 log-softmax sums in
either framework's order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_hackathon_tpu as paddle
from paddle_hackathon_tpu import nn as jnn
from paddle_hackathon_tpu.core.tensor import Tensor
from paddle_hackathon_tpu.inference import ServingEngine as JEngine
from paddle_hackathon_tpu.models.gpt import GPTConfig as JConfig
from paddle_hackathon_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_hackathon_tpu.nn import decode as jdec
from paddle_hackathon_tpu_torch import nn as tnn
from paddle_hackathon_tpu_torch.inference import ServingEngine
from paddle_hackathon_tpu_torch.models import gpt as tgpt
from paddle_hackathon_tpu_torch.nn import decode as tdec
from paddle_hackathon_tpu_torch.utils import load_jax_state

_CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            max_position_embeddings=128, hidden_dropout_prob=0.0,
            attention_dropout_prob=0.0, use_flash_attention=False)
_SPEC = ("spec_ticks", "spec_drafted", "spec_accepted")


def _pair(seed, layers):
    """(JAX model, port model) on the JAX model's weights."""
    paddle.seed(seed)
    jm = JGPT(JConfig(**dict(_CFG, num_layers=layers)))
    jm.eval()
    arrays = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**dict(_CFG, num_layers=layers)),
                             device="cpu")
    load_jax_state(tm, arrays)
    return jm, tm


@pytest.fixture(scope="module")
def models():
    """The target pair (2 layers) and the draft pair (1 layer), as the
    reference's spec tests build them."""
    return _pair(3, 2), _pair(11, 1)


def _prompts(k, lens=(6, 11, 5, 9)):
    rs = np.random.RandomState(5)
    return [rs.randint(0, 128, (lens[i % len(lens)],)).astype(np.int32)
            for i in range(k)]


def _drafter(models, which, side):
    """'ngram', or the draft model of the given side (0 JAX, 1 port)."""
    return "ngram" if which == "ngram" else models[1][side]


# ---------------------------------------------------------------- drafters

def test_accept_lengths_matches_reference():
    rs = np.random.RandomState(0)
    for K in (0, 1, 4, 8):
        drafts = rs.randint(0, 3, (16, K))
        verified = rs.randint(0, 3, (16, K + 1))
        ndraft = rs.randint(0, K + 1, 16)
        np.testing.assert_array_equal(
            tdec.accept_lengths(drafts, ndraft, verified),
            jdec.accept_lengths(drafts, ndraft, verified))


def test_ngram_propose_matches_reference():
    rs = np.random.RandomState(1)
    hist = rs.randint(0, 6, (5, 40)).astype(np.int32)
    starts = np.array([0, 1, 7, 20, 39], np.int32)
    last = rs.randint(0, 6, 5).astype(np.int32)
    got = []
    for mod in (jdec, tdec):
        dr = mod.NGramDrafter(k=4, max_ngram=3)
        dr.begin(5, 48)
        dr.ingest(hist, np.zeros(5, np.int32), starts)
        got.append(dr.propose(last, starts))
    for a, b in zip(*got):
        np.testing.assert_array_equal(a, b)
    assert got[1][1].any()         # the case proposes something


def test_model_drafter_propose_matches_reference(models):
    (_, _), (jd, td) = models
    prompts = np.stack(_prompts(3, lens=(9,)))
    got = []
    for mod, m in ((jdec, jd), (tdec, td)):
        dr = mod.ModelDrafter(m, k=4)
        dr.begin(3, 40)
        dr.ingest(prompts, np.zeros(3, np.int32), np.full(3, 9, np.int32))
        d1, n1 = dr.propose(np.array([5, 6, 7], np.int32),
                            np.full(3, 9, np.int32))
        # a second round from the committed lengths a verify would leave
        d2, n2 = dr.propose(d1[:, 1], np.array([11, 10, 12], np.int32))
        got.append((d1, n1, d2, n2))
    for a, b in zip(*got):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_model_drafter_reads_current_weights(models):
    """The drafter runs the draft model's modules as they stand: a weight
    changed after construction changes the proposals."""
    (_, _), (_, td) = models
    m = tgpt.GPTForCausalLM(td.config, device="cpu")
    m.load_state_dict(td.state_dict())
    dr = tdec.ModelDrafter(m, k=3)
    ids = np.stack(_prompts(2, lens=(6,)))

    def propose():
        dr.begin(2, 16)
        dr.ingest(ids, np.zeros(2, np.int32), np.full(2, 6, np.int32))
        return dr.propose(np.array([1, 2], np.int32),
                          np.full(2, 6, np.int32))[0]
    before = propose()
    with torch.no_grad():       # every position now leans to token 5
        m.gpt.wpe.weight.copy_(10 * m.gpt.wte.weight[5])
    assert not np.array_equal(propose(), before)


def test_get_drafter_resolution(models):
    (_, _), (_, td) = models
    assert isinstance(tdec.get_drafter(None, 4), tdec.NGramDrafter)
    assert isinstance(tdec.get_drafter("ngram", 4), tdec.NGramDrafter)
    assert isinstance(tdec.get_drafter(td, 4), tdec.ModelDrafter)
    dr = tdec.NGramDrafter(k=4)
    assert tdec.get_drafter(dr, 4) is dr
    with pytest.raises(ValueError, match="spec_k"):
        tdec.get_drafter(tdec.NGramDrafter(k=2), 4)
    with pytest.raises(TypeError):
        tdec.get_drafter(123, 4)


# ------------------------------------------------------------- beam search

@pytest.mark.parametrize("beam,end", [(3, 1), (4, 5)])
def test_beam_search_matches_reference(beam, end):
    """``BeamSearchDecoder`` + ``dynamic_decode`` over the same cell (an
    embedding, a tanh recurrence, an output projection) in each
    framework: ids equal, final log-probs within 1e-5."""
    V, D, B = 12, 8, 2
    paddle.seed(0)
    emb, cell_lin, out_lin = (jnn.Embedding(V, D), jnn.Linear(D, D),
                              jnn.Linear(D, V))

    def jcell(x, states):
        h = paddle.tanh(cell_lin(x) + states)
        return h, h
    jd = jnn.BeamSearchDecoder(jcell, start_token=0, end_token=end,
                               beam_size=beam, embedding_fn=emb,
                               output_fn=out_lin)
    init = np.random.RandomState(2).randn(B, D).astype(np.float32)
    jids, jlp = jnn.dynamic_decode(jd, paddle.to_tensor(init),
                                   max_step_num=6)

    w = {k: torch.tensor(np.asarray(v.numpy())) for k, v in (
        ("e", emb.weight), ("cw", cell_lin.weight), ("cb", cell_lin.bias),
        ("ow", out_lin.weight), ("ob", out_lin.bias))}

    def tcell(x, states):
        h = torch.tanh(x @ w["cw"] + w["cb"] + states)
        return h, h
    td = tnn.BeamSearchDecoder(
        tcell, start_token=0, end_token=end, beam_size=beam,
        embedding_fn=lambda ids: w["e"][ids],
        output_fn=lambda h: h @ w["ow"] + w["ob"])
    tids, tlp = tnn.dynamic_decode(td, torch.tensor(init), max_step_num=6)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids.numpy()))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp.numpy()),
                               rtol=0, atol=1e-5)


def test_gather_tree_matches_reference():
    from paddle_hackathon_tpu.nn import functional as JF
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 10, (4, 2, 3)).astype(np.int64)
    par = rng.randint(0, 3, (4, 2, 3)).astype(np.int64)
    ref = np.asarray(JF.gather_tree(paddle.to_tensor(ids),
                                    paddle.to_tensor(par)).numpy())
    np.testing.assert_array_equal(
        tdec.gather_tree(torch.tensor(ids), torch.tensor(par)).numpy(), ref)


def test_top_k_ties_break_by_lower_index():
    """Equal scores: the stable sort keeps lax.top_k's order (lower
    flat index first), where torch.topk's order is unspecified."""
    V = 6
    dec = tnn.BeamSearchDecoder(lambda x, s: (torch.zeros(x.numel(), V), s),
                                start_token=0, end_token=5, beam_size=3)
    ids, states, lp, fin = dec.initialize(torch.zeros(1, 2))
    tok, parent, _, top, _ = dec.step(ids, states, lp, fin)
    np.testing.assert_array_equal(tok.numpy(), [[0, 1, 2]])
    np.testing.assert_array_equal(parent.numpy(), [[0, 0, 0]])


# ----------------------------------------------------- generate(spec_k=...)

@pytest.mark.parametrize("which", ["ngram", "model"])
def test_generate_spec_matches_jax(models, which):
    """Greedy ``generate(spec_k=4)`` token-exact against the JAX package's,
    batched over mixed prompts and a repetitive one, with equal
    ``_last_spec_stats``; and against the port's own non-spec output."""
    (jm, tm), _ = models
    prompts = [np.stack(_prompts(2, lens=(9,))),
               np.tile(np.array([9, 7, 5], np.int32), 6)[None]]
    for ids in prompts:
        ref = np.asarray(jm.generate(
            Tensor(jnp.asarray(ids)), max_new_tokens=10, temperature=0.0,
            spec_k=4, drafter=_drafter(models, which, 0)).numpy())
        out = tm.generate(ids, 10, temperature=0.0, spec_k=4,
                          drafter=_drafter(models, which, 1))
        np.testing.assert_array_equal(out.numpy(), ref)
        assert tm._last_spec_stats == jm._last_spec_stats
        np.testing.assert_array_equal(
            out.numpy(), tm.generate(ids, 10, temperature=0.0).numpy())


def test_static_cache_write_past_end_lands_in_last_row(models):
    """The verify near a row's budget writes past a cache of the non-spec
    length: those rows land in the last row, and the rows before it keep
    what they held (the reference's clamp would shift the window back
    onto them)."""
    (_, tm), _ = models
    caches = tm._static_caches(2, 12)
    for k, v in caches:
        k.fill_(7.0)
        v.fill_(7.0)
    with torch.inference_mode():
        tm(torch.ones(2, 5, dtype=torch.long), caches=caches,
           cache_pos=torch.tensor([2, 9], dtype=torch.int32))
    k0 = caches[0][0]
    assert (k0[0, :2] == 7.0).all() and (k0[0, 7:] == 7.0).all()
    assert (k0[0, 2:7] != 7.0).any(-1).all()       # rows 2..6 written
    assert (k0[1, :9] == 7.0).all()                 # rows before 9 kept
    assert (k0[1, 9:] != 7.0).any(-1).all()


def test_generate_spec_requires_greedy(models):
    (_, tm), _ = models
    (p,) = _prompts(1)
    with pytest.raises(ValueError, match="temperature=0.0"):
        tm.generate(p[None], 4, temperature=0.8, spec_k=2)
    with pytest.raises(ValueError, match="jit_decode"):
        tm.generate(p[None], 4, temperature=0.0, spec_k=2, jit_decode=False)


# ----------------------------------------------------- engine verify tick

def _serve(engine, prompts, new, **kw):
    reqs = [engine.submit(p, new, **kw) for p in prompts]
    engine.run_until_idle()
    assert all(r.done for r in reqs)
    return [r.result() for r in reqs]


@pytest.mark.parametrize("mode", ["dense", "paged"])
@pytest.mark.parametrize("which", ["ngram", "model"])
def test_engine_spec_matches_jax_engine(models, mode, which):
    """The verify tick, dense and paged, with both drafters: token-exact
    against the JAX engine and against the port's engine without spec;
    spec_ticks / spec_drafted / spec_accepted equal the JAX engine's; no
    page leaks."""
    (jm, tm), _ = models
    kw = dict(max_slots=4, max_len=64, chunk=4, spec_k=4, cache_mode=mode,
              page_size=8)
    prompts = _prompts(3) + [np.tile(np.array([9, 7, 5], np.int32), 4)]
    je = JEngine(jm, auto_run=False, drafter=_drafter(models, which, 0),
                 **kw)
    refs = _serve(je, prompts, 10)
    te = ServingEngine(tm, auto_run=False,
                       drafter=_drafter(models, which, 1), **kw)
    outs = _serve(te, prompts, 10)
    plain = _serve(ServingEngine(tm, auto_run=False, **dict(kw, spec_k=0)),
                   prompts, 10)
    for out, ref, p in zip(outs, refs, plain):
        np.testing.assert_array_equal(out, ref)
        np.testing.assert_array_equal(out, p)
    assert {k: te.stats[k] for k in _SPEC} == {k: je.stats[k] for k in _SPEC}
    assert te.stats["spec_ticks"] >= 1
    assert te.stats["tokens"] == je.stats["tokens"] == 40
    if mode == "paged":
        te.drop_prefix_cache()
        assert te.kv_pages_in_use == 0


def test_engine_spec_acceptance_on_repetitive_stream(models):
    """A periodic prompt: acceptance engages, the decode phase averages
    more than one token a tick, and the counters equal the JAX
    engine's."""
    (jm, tm), _ = models
    p = np.tile(np.array([9, 7, 5], np.int32), 6)
    kw = dict(max_slots=2, max_len=96, chunk=4, spec_k=4)
    je = JEngine(jm, auto_run=False, **kw)
    ref = _serve(je, [p], 12)[0]
    te = ServingEngine(tm, auto_run=False, **kw)
    np.testing.assert_array_equal(_serve(te, [p], 12)[0], ref)
    assert te.stats["spec_accepted"] > 0
    assert te.stats["spec_ticks"] < te.stats["tokens"] - 1
    assert {k: te.stats[k] for k in _SPEC} == {k: je.stats[k] for k in _SPEC}


def test_engine_spec_with_mixed_sampling_slots(models):
    """A temperature > 0 request beside a greedy one: it drafts nothing
    and samples, while the greedy stream stays token-exact."""
    (jm, tm), _ = models
    p_greedy, p_sampled = _prompts(2)
    ref = np.asarray(jm.generate(Tensor(jnp.asarray(p_greedy[None])),
                                 max_new_tokens=10,
                                 temperature=0.0).numpy())[0]
    eng = ServingEngine(tm, auto_run=False, max_slots=2, max_len=64, chunk=4,
                        spec_k=4)
    r0 = eng.submit(p_greedy, 10)
    r1 = eng.submit(p_sampled, 10, temperature=0.9, top_k=20)
    eng.run_until_idle()
    np.testing.assert_array_equal(r0.result(), ref)
    out1 = r1.result()
    assert out1.shape == (len(p_sampled) + 10,)
    assert ((out1 >= 0) & (out1 < 128)).all()
    assert eng.stats["spec_ticks"] > 0


def test_engine_spec_all_sampling_falls_back_to_multi_window(models):
    """No greedy slot: the multi window runs, not the verify; a greedy
    request joining later engages spec with the drafter in sync (the
    window's rows were mirrored into it) and stays token-exact."""
    (jm, tm), _ = models
    p_greedy, p_sampled = _prompts(2)
    ref = np.asarray(jm.generate(Tensor(jnp.asarray(p_greedy[None])),
                                 max_new_tokens=10,
                                 temperature=0.0).numpy())[0]
    eng = ServingEngine(tm, auto_run=False, max_slots=2, max_len=64, chunk=4,
                        temperature=0.8, spec_k=4, decode_window=4)
    r_s = eng.submit(p_sampled, 6)
    for _ in range(4):
        eng.step()
    assert eng.stats["spec_ticks"] == 0
    assert eng.stats["decode_ticks"] > 0
    r_g = eng.submit(p_greedy, 10, temperature=0.0)
    eng.run_until_idle()
    assert r_s.done and r_g.done
    np.testing.assert_array_equal(r_g.result(), ref)
    assert eng.stats["spec_ticks"] > 0


def test_submit_capacity_guard_covers_spec_headroom(models):
    """The verify write needs spec_k + 1 rows of headroom: the capacity
    check uses max(chunk, spec_k + 1), in pages too."""
    (_, tm), _ = models
    eng = ServingEngine(tm, auto_run=False, max_slots=2, max_len=32, chunk=4,
                        spec_k=7)
    with pytest.raises(ValueError, match="cache rows"):
        # fits max_len-chunk=28 but NOT max_len-(spec_k+1)=24
        eng.submit(np.arange(10, dtype=np.int32), max_new_tokens=16)
    req = eng.submit(np.arange(10, dtype=np.int32), max_new_tokens=14)
    eng.run_until_idle()
    assert req.done and len(req.tokens) == 14
    # paged: the footprint covers the 8-row verify window past the last
    # row (rows 0..31 over pages of 4: 8 pages, where the chunk's 4-row
    # window would need 7)
    paged = ServingEngine(tm, auto_run=False, max_slots=2, max_len=32,
                          chunk=4, spec_k=7,
                          cache_mode="paged", page_size=4)
    r = paged.submit(np.arange(10, dtype=np.int32), max_new_tokens=14)
    paged.step()
    assert len(paged._slot_pages[0]) == 8
    paged.run_until_idle()
    assert r.done and len(r.tokens) == 14
    np.testing.assert_array_equal(r.result(), req.result())


def test_prefix_hit_replays_skipped_rows_to_drafter(models):
    """A prefix-cache hit skips re-prefilling its pages; the drafter's
    mirror gets those rows replayed, so the second request's history and
    proposals match a cold start, its output is token-exact and the spec
    counters equal the JAX engine's on the same sequence."""
    (jm, tm), _ = models
    prompt = np.tile(np.array([9, 7, 5, 3], np.int32), 5)   # 20 tokens
    kw = dict(max_slots=2, max_len=64, chunk=4, spec_k=4,
              cache_mode="paged", page_size=8)
    je = JEngine(jm, auto_run=False, **kw)
    te = ServingEngine(tm, auto_run=False, **kw)
    for e in (je, te):
        first = _serve(e, [prompt], 8)[0]
        second = _serve(e, [prompt], 8)[0]
        np.testing.assert_array_equal(first, second)
    np.testing.assert_array_equal(second, _serve(je, [prompt], 8)[0])
    np.testing.assert_array_equal(_serve(te, [prompt], 8)[0], second)
    assert te.stats["prefix_hit_tokens"] == je.stats["prefix_hit_tokens"] \
        == 32                          # 2 pages skipped on each rerun
    assert {k: te.stats[k] for k in _SPEC} == {k: je.stats[k] for k in _SPEC}
    # the replayed rows sit in the drafter's history
    slot_hist = te._spec._hist[0, :16]
    np.testing.assert_array_equal(slot_hist, prompt[:16])
