"""Beam-search decoding and the speculative-decoding drafters: the port
of the JAX package's ``nn/decode.py``.

``BeamSearchDecoder`` and ``dynamic_decode`` run the decode loop step by
step over a cell that maps torch tensors to ``(out, states)``;
:func:`gather_tree` backtracks the beams at the end.  Scores are
log-probabilities; finished beams are frozen by masking their step
log-probs to one-hot(EOS) = 0.

The drafters (``accept_lengths``, ``NGramDrafter``, ``ModelDrafter``,
``get_drafter``) feed speculative decoding in
``GPTForCausalLM.generate(spec_k=...)`` and the serving engine's verify
tick; their contract is set out below, above :func:`accept_lengths`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..observability.sanitizers import device_get


def gather_tree(ids, parents):
    """Beam-search backtrace: walk the parent pointers from the last step
    back to the first, emitting the full id sequence of every final beam.
    ``ids`` / ``parents`` are (max_time, batch, beam) integer tensors; so
    is the result."""
    t_len, b, w = ids.shape
    beams = torch.arange(w, device=ids.device).expand(b, w)
    out = []
    for t in range(t_len - 1, -1, -1):
        out.append(ids[t].gather(1, beams))
        beams = parents[t].gather(1, beams)
    return torch.stack(out[::-1], 0)


class BeamSearchDecoder:
    """Beam-search wrapper around a cell (ref decode.py BeamSearchDecoder).

    ``embedding_fn`` maps token ids -> embeddings; ``output_fn`` maps cell
    outputs -> vocab logits (both optional if the cell does it).
    """

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    # -- helpers (shapes: B=batch, W=beam, V=vocab) ------------------------
    def _merge(self, x):  # (B, W, ...) -> (B*W, ...)
        return x.reshape((-1,) + tuple(x.shape[2:]))

    def _split(self, x, batch):  # (B*W, ...) -> (B, W, ...)
        return x.reshape((batch, self.beam_size) + tuple(x.shape[1:]))

    def initialize(self, initial_cell_states):
        """Tile cell states across beams; first beam active, rest -inf."""
        cell_states = _tree_map(
            lambda s: torch.as_tensor(s).repeat_interleave(
                self.beam_size, dim=0), initial_cell_states)
        first = torch.as_tensor(_tree_first(initial_cell_states))
        batch, dev = first.shape[0], first.device
        ids = torch.full((batch, self.beam_size), self.start_token,
                         dtype=torch.int64, device=dev)
        log_probs = torch.tensor(
            [[0.0] + [-1e9] * (self.beam_size - 1)],
            dtype=torch.float32, device=dev).repeat(batch, 1)
        finished = torch.zeros((batch, self.beam_size), dtype=torch.bool,
                               device=dev)
        return ids, cell_states, log_probs, finished

    def step(self, inputs, states, log_probs, finished):
        """One decode step: expand each beam over the vocab, take top-W."""
        if self.embedding_fn is not None:
            inputs = self.embedding_fn(inputs)
        batch = inputs.shape[0]
        flat_in = self._merge(inputs) if inputs.dim() > 2 else inputs
        out, next_states = self.cell(flat_in, states)
        if self.output_fn is not None:
            out = self.output_fn(out)
        vocab = out.shape[-1]
        step_lp = torch.log_softmax(out.float(), -1)
        step_lp = step_lp.reshape(batch, self.beam_size, vocab)
        # frozen beams only extend with EOS at 0 cost
        eos = torch.full((vocab,), -1e9, device=step_lp.device)
        eos[self.end_token] = 0.0
        step_lp = torch.where(finished[..., None], eos, step_lp)
        total = log_probs[..., None] + step_lp  # (B, W, V)
        flat = total.reshape(batch, -1)
        # jax.lax.top_k breaks ties by the lower index; torch.topk leaves
        # their order unspecified.  A stable descending sort keeps equal
        # scores in index order, so its first W entries are lax.top_k's.
        top_lp, top_idx = flat.sort(dim=-1, descending=True, stable=True)
        top_lp = top_lp[:, :self.beam_size]
        top_idx = top_idx[:, :self.beam_size]
        parent = top_idx // vocab  # (B, W)
        token = top_idx % vocab
        rows = torch.arange(batch, device=parent.device)[:, None]

        def reorder(s):  # each beam's state from its parent beam
            return self._merge(self._split(s, batch)[rows, parent])
        next_states = _tree_map(reorder, next_states)
        new_fin = finished.gather(1, parent) | (token == self.end_token)
        return token, parent, next_states, top_lp, new_fin


@torch.no_grad()
def dynamic_decode(decoder, inits=None, max_step_num=64,
                   output_time_major=False, **kwargs):
    """Run the decoder until all beams finish or max steps (ref
    decode.py dynamic_decode). Returns (ids, final_log_probs): ids of shape
    (B, T, W) — backtracked with gather_tree."""
    ids, states, log_probs, finished = decoder.initialize(inits)
    step_ids = [ids]  # predicted tokens per step
    parents = []
    tokens = ids
    for _ in range(int(max_step_num)):
        token, parent, states, log_probs, finished = decoder.step(
            tokens, states, log_probs, finished)
        step_ids.append(token)
        parents.append(parent)
        tokens = token
        if bool(finished.all()):
            break
    final = gather_tree(torch.stack(step_ids[1:], 0),
                        torch.stack(parents, 0))  # (T, B, W)
    out = final if output_time_major else final.permute(1, 0, 2)
    return out, log_probs


# ---------------------------------------------------------------------------
# Speculative-decoding drafters (Leviathan et al. 2023; prompt-lookup /
# n-gram self-drafting per Saxena 2023).
#
# A drafter proposes up to ``k`` continuation tokens per stream; the target
# model scores all proposals plus one bonus position in ONE widened forward
# (the serving engine's verify tick / ``GPTForCausalLM.generate(spec_k=...)``)
# and commits the longest prefix matching its own greedy argmax — so under
# greedy sampling the output is token-for-token identical to non-speculative
# decoding, whatever the drafter proposes.  Drafter quality only moves the
# acceptance rate (speed), never correctness.
#
# Both drafters speak one slot-batched interface so the engine and the
# single-request generate() drive them identically:
#
#   begin(batch, cache_len)          allocate per-stream state
#   ingest(tokens, starts, nvalid)   committed token chunk per stream —
#                                    exactly what the target tick wrote to
#                                    its KV cache (prefill chunks and
#                                    accepted verify chunks alike)
#   propose(last, starts)            -> (drafts (B, k) int32, ndraft (B,))
#
# ``starts`` is each stream's committed length (the cache write offset);
# ``last`` is the pending sampled token not yet written.  Stale draft-cache
# rows past a stream's committed length are never read (attention masks
# kpos <= qpos and every forward rewrites [starts, starts+width)), so
# rejected proposals need no rollback on either side.
# ---------------------------------------------------------------------------


def accept_lengths(drafts, ndraft, verified):
    """Per-stream count of leading draft tokens the verify pass accepted.

    ``drafts`` (B, K) proposals, ``ndraft`` (B,) valid proposal counts,
    ``verified`` (B, >=K) the target's greedy tokens at each position.
    Row i accepts ``a`` = the longest prefix with
    ``drafts[i, t] == verified[i, t]`` for all ``t < a <= ndraft[i]``;
    the caller then commits ``verified[i, :a+1]`` (accepted + bonus)."""
    drafts = np.asarray(drafts)
    B, K = drafts.shape
    if K == 0:
        return np.zeros(B, np.int32)
    ok = (np.arange(K)[None, :] < np.asarray(ndraft)[:, None]) \
        & (drafts == np.asarray(verified)[:, :K])
    return np.cumprod(ok, axis=1).sum(axis=1).astype(np.int32)


class NGramDrafter:
    """Model-free prompt-lookup drafter: propose the continuation of the
    most recent earlier occurrence of the stream's current suffix n-gram
    (falling from ``max_ngram`` down to ``min_ngram``).  Zero device work;
    pays off whenever generation revisits its own history (code, prose,
    the repetition attractors of greedy decoding)."""

    # propose() writes nothing: the engine must replay committed verify
    # chunks into ingest() (see ingest_after_verify contract below)
    ingest_after_verify = True

    def __init__(self, k=4, max_ngram=3, min_ngram=1):
        self.k = int(k)
        self.max_ngram = int(max_ngram)
        self.min_ngram = max(1, int(min_ngram))
        self._hist = None

    def begin(self, batch, cache_len):
        self._hist = np.zeros((int(batch), int(cache_len)), np.int32)

    def ingest(self, tokens, starts, nvalid):
        # the committed length itself is not tracked here: propose()'s
        # ``starts`` is the source of truth (slot reuse resets it to 0)
        tokens = np.asarray(tokens, np.int32)
        for i in range(tokens.shape[0]):
            s, n = int(starts[i]), int(nvalid[i])
            if n > 0:
                self._hist[i, s:s + n] = tokens[i, :n]

    def _lookup(self, seq):
        L = len(seq)
        for n in range(min(self.max_ngram, L - 1), self.min_ngram - 1, -1):
            pat = seq[L - n:]
            win = np.lib.stride_tricks.sliding_window_view(seq, n)
            hits = np.nonzero((win[:L - n] == pat).all(axis=1))[0]
            if hits.size:
                j = int(hits[-1])  # most recent occurrence wins
                cont = seq[j + n:j + n + self.k]
                if cont.size:
                    return cont
        return np.zeros(0, np.int32)

    def propose(self, last, starts):
        B = len(last)
        drafts = np.zeros((B, self.k), np.int32)
        ndraft = np.zeros(B, np.int32)
        for i in range(B):
            seq = np.append(self._hist[i, :int(starts[i])],
                            np.int32(last[i]))
            cont = self._lookup(seq)
            ndraft[i] = len(cont)
            drafts[i, :len(cont)] = cont
        return drafts, ndraft


class ModelDrafter:
    """Draft proposals from a small ``GPTForCausalLM``: the classic
    two-model speculative setup.  Keeps its own slot-batched static KV
    cache mirroring the target's length accounting; ``ingest`` replays
    committed chunks through the draft backbone at ``cache_pos = starts``
    (prefill chunks and decode-window tokens the drafter never saw),
    ``propose`` runs ``k + 1`` width-1 greedy feeds, so its own cache
    writes at ``[starts, starts+k]`` already hold every token any
    acceptance outcome can commit (``[last, p_0..p_{a-1}]`` for a <= k).
    ``ingest_after_verify = False`` therefore lets callers skip the
    post-verify replay: re-running it would recompute identical KV.
    Rejected-tail rows are scratch — the next forward rewrites them
    before any query can attend (kpos <= qpos masking).

    Every call runs the draft model's modules as they stand, so it reads
    the model's current weights, never a copy taken at construction."""

    ingest_after_verify = False

    def __init__(self, model, k=4):
        model.eval()
        self.model = model
        self.k = int(k)
        self._caches = None

    def begin(self, batch, cache_len):
        self._caches = self.model._static_caches(int(batch), int(cache_len))

    def _dev(self, a):
        return torch.as_tensor(np.asarray(a, np.int32),
                               device=self.model.device)

    @torch.inference_mode()
    def ingest(self, tokens, starts, nvalid=None):
        # nvalid is unused on the device: rows past it are scratch the
        # draft attention can never read (see the class docstring)
        self.model.gpt(self._dev(tokens).long(), caches=self._caches,
                       cache_pos=self._dev(starts))

    @torch.inference_mode()
    def propose(self, last, starts):
        gpt = self.model.gpt
        cur = self._dev(last).long()
        pos = self._dev(starts)
        out = []
        # K+1 feeds: the last one writes p_{K-1}'s KV row so a
        # fully-accepted verify needs no replay (its proposal is
        # discarded)
        for t in range(self.k + 1):
            hidden, _ = gpt(cur[:, None], caches=self._caches,
                            cache_pos=pos + t)
            cur = (hidden[:, 0] @ gpt.wte.weight.T).float().argmax(-1)
            out.append(cur)
        # the drafter's one designed device->host fetch per propose
        drafts = device_get(torch.stack(out[:self.k], 1).to(torch.int32))
        return drafts, np.full(drafts.shape[0], self.k, np.int32)


def get_drafter(spec, k):
    """Resolve a drafter argument: ``None``/'ngram' -> :class:`NGramDrafter`,
    a ``GPTForCausalLM``-shaped model -> :class:`ModelDrafter`, an object
    already speaking the drafter interface -> itself."""
    if spec is None or spec == "ngram":
        return NGramDrafter(k=k)
    if hasattr(spec, "propose") and hasattr(spec, "begin"):
        if getattr(spec, "k", k) != k:
            raise ValueError(
                f"drafter proposes k={spec.k} tokens but spec_k={k}")
        return spec
    if hasattr(spec, "gpt") and hasattr(spec, "config"):
        return ModelDrafter(spec, k=k)
    raise TypeError(f"cannot build a drafter from {type(spec).__name__}; "
                    "pass 'ngram', a GPTForCausalLM, or a drafter object")


def _tree_map(fn, tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_first(tree):
    if isinstance(tree, (list, tuple)):
        return _tree_first(tree[0])
    if isinstance(tree, dict):
        return _tree_first(next(iter(tree.values())))
    return tree
