"""GPT-style decoder-only LM: the port of the JAX package's
``models/gpt.py`` for serving and training.

Parameter names and layouts are the JAX model's (``gpt.wte.weight``,
``gpt.blocks.0.attn.qkv_proj.weight`` of shape ``(in, out)``, ...), so a
JAX ``state_dict()`` exported to numpy loads name for name
(``utils/convert.py``).  Attention has three branches, as in the
reference:

- paged KV (the serving engine's ``cache_mode="paged"``): write the step's
  K/V through the page table, then the paged-attention kernel
  (``incubate/nn/kernels/paged_attention.py``);
- static cache (``generate`` and the dense engine): write at
  ``cache_pos``, then the plain masked-softmax composition;
- growing cache (``caches`` without ``cache_pos``, from
  ``gen_empty_caches``): the step's K/V appended to the cache, then
  ``scaled_dot_product_attention`` (a chunk of rows under the additive
  mask of its past length, one row unmasked);
- no cache: dispatched in the JAX package's order.  The packed-qkv
  flash kernels (K1, ``incubate/nn/kernels/flash_attention_packed.py``)
  where ``_packed_flash_ok`` holds; else ``nn.functional
  .scaled_dot_product_attention(is_causal=True)``, which takes the bhd
  flash kernels (K2, ``incubate/nn/kernels/flash_attention.py``) where
  flash is asked for and their gate takes the length (every f32 model at
  s >= 1024 by default), and the plain composition otherwise.

Matrix products and the dense static-cache attention stay ordinary
PyTorch, as the JAX package left them to XLA; a projection swapped for a
``nn.quant.WeightOnlyLinear`` (a quantized serving artifact) runs the
dequant-GEMM kernel K4 instead.  Caches are updated IN
PLACE (the JAX code rebuilt them functionally); each branch returns the
same cache tensors it was given.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np
import torch

from ..core import flags
from ..core.device import resolve_device
from ..core.dtype import convert_dtype
from ..core.random import default_generator
from ..incubate.nn.functional import flash_attention_qkv_packed
from ..incubate.nn.kernels import flash_attention_packed as _fap
from ..incubate.nn.kernels import paged_attention as _pa
from ..nn.functional import (cross_entropy, gelu,
                             scaled_dot_product_attention)
from ..nn.decode import accept_lengths, get_drafter
from ..nn.container import LayerList
from ..nn.layer import Layer
from ..nn import initializer as I
from ..nn.layers import Dropout, Embedding, LayerNorm, Linear
from ..nn.parameter import ParamAttr
from ..observability.sanitizers import device_get

_NEG_INF = -1e30


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: Optional[int] = None
    max_position_embeddings: int = 1024
    hidden_dropout_prob: float = 0.1
    attention_dropout_prob: float = 0.1
    initializer_range: float = 0.02
    use_flash_attention: bool = None  # None = auto (seq-length heuristic)
    # GPT-MoE: not ported yet (moe_num_experts > 0 raises); the other moe_*
    # fields are kept with the JAX defaults so that a JAX config.json
    # (inference/serving.py save_for_serving) rebuilds here
    moe_num_experts: int = 0
    moe_topk: int = 2
    moe_gate: str = "naive"
    moe_capacity_factor: float = 2.0
    moe_aux_weight: float = 0.01
    moe_every_n: int = 1
    moe_group_size: Optional[int] = None

    @property
    def ffn_size(self):
        return self.intermediate_size or 4 * self.hidden_size


_GPT_PRESETS = {
    # name: (layers, hidden, heads) -- paddle fleetx GPT configs
    "gpt2-small-en": (12, 768, 12),         # 124M
    "gpt2-medium-en": (24, 1024, 16),       # 350M
    "gpt2-large-en": (36, 1280, 20),        # 774M
    "gpt3-1.3B-en": (24, 2048, 16),
    "gpt3-2.7B-en": (32, 2560, 32),
    "gpt3-6.7B-en": (32, 4096, 32),
}


def gpt_config(name: str, **overrides) -> GPTConfig:
    layers, hidden, heads = _GPT_PRESETS[name]
    cfg = GPTConfig(num_layers=layers, hidden_size=hidden, num_heads=heads)
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg


def _positions(pos: torch.Tensor, s: int, max_pos: int) -> torch.Tensor:
    """(B, s) or (1, s) absolute positions from a per-slot (B,) or scalar
    write offset, clipped to the position table."""
    pos = pos.to(torch.long)
    ar = torch.arange(s, device=pos.device)
    idx = pos[:, None] + ar[None, :] if pos.dim() else (pos + ar)[None, :]
    return idx.clamp(0, max_pos - 1)


def _normal_attr(config: GPTConfig) -> ParamAttr:
    """The JAX model's weight attribute: ``Normal(0, initializer_range)``
    drawn from the device's default generator as the layer is built."""
    return ParamAttr(initializer=I.Normal(0.0, config.initializer_range))


class GPTAttention(Layer):
    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_heads
        self.head_dim = h // config.num_heads
        kw = {"weight_attr": _normal_attr(config), "device": device,
              "dtype": dtype}
        self.qkv_proj = Linear(h, 3 * h, **kw)
        self.out_proj = Linear(h, h, **kw)
        self.dropout_p = config.attention_dropout_prob
        self.use_flash = config.use_flash_attention

    def _split(self, qkv):
        b, s, _ = qkv.shape
        return qkv.reshape(b, s, 3, self.num_heads, self.head_dim).unbind(2)

    def _packed_flash_ok(self, qkv, s) -> bool:
        """The JAX test for the packed-qkv kernels: not switched off,
        ``use_flash=True`` at any supported length or auto at the
        min-seqlen crossover, and a shape and dtype the kernels take."""
        if self.use_flash is False or not flags.flag("use_fused_kernels"):
            return False
        if self.use_flash is None and \
                s < flags.flag("flash_attention_min_seqlen"):
            return False
        return _fap.supported(s, s, self.num_heads, self.head_dim,
                              qkv.dtype)

    def forward(self, x, cache=None, cache_pos=None, page_table=None):
        b, s, h = x.shape
        if page_table is not None:
            # paged KV: ``cache`` is the layer's (num_pages, page_size, H,
            # D) pool pair shared by every slot, ``cache_pos`` the per-slot
            # write offset.  Write through the table, then attend through
            # it; both run on the current stream, so the write lands before
            # the kernel reads.
            if cache_pos is None:
                raise ValueError("page_table requires cache_pos")
            q, k, v = self._split(self.qkv_proj(x))
            kp, vp = cache
            _pa.paged_write(kp, k, page_table, cache_pos)
            _pa.paged_write(vp, v, page_table, cache_pos)
            ctx = _pa.paged_attention(q.contiguous(), kp, vp, page_table,
                                      cache_pos)
            return self.out_proj(ctx.reshape(b, s, h)), (kp, vp)
        if cache_pos is not None:
            # static cache: a fixed (B, max_len, H, D) pair; this call's
            # K/V land at [cache_pos, cache_pos + s) (per slot when
            # cache_pos is (B,)), and queries attend cached positions <=
            # their global position
            q, k, v = self._split(self.qkv_proj(x))
            kb, vb = cache
            T = kb.shape[1]
            pos = cache_pos.to(torch.long).expand(b) \
                if cache_pos.dim() == 0 else cache_pos.to(torch.long)
            ar = torch.arange(s, device=x.device)
            qpos = pos[:, None] + ar[None, :]
            # rows past the cache's end land in its last row (JAX's
            # dynamic_update_slice shifts the window back instead, onto
            # rows already written); several such rows scatter to that one
            # row and which write lands is unspecified, so a caller that
            # writes past the end must discard the output of every query
            # that can read row T - 1
            rows = qpos.clamp(0, T - 1)
            mask = (torch.arange(T, device=x.device)[None, None, :]
                    <= qpos[..., None])[:, None]                 # (b,1,s,T)
            bidx = torch.arange(b, device=x.device)[:, None].expand(b, s)
            kb[bidx, rows] = k.to(kb.dtype)
            vb[bidx, rows] = v.to(vb.dtype)
            scale = 1.0 / math.sqrt(self.head_dim)
            logits = torch.einsum("bshe,bthe->bhst", q,
                                  kb.to(q.dtype)) * scale
            logits = logits.masked_fill(~mask, _NEG_INF)
            probs = torch.softmax(logits, -1)
            ctx = torch.einsum("bhst,bthe->bshe", probs, vb.to(probs.dtype))
            return self.out_proj(ctx.reshape(b, s, h)), (kb, vb)
        if cache is not None:
            # growing cache: this call's K/V appended to the layer's (B,
            # past, H, D) pair (in K/V's dtype); a chunk of s > 1 rows
            # attends keys up to its global position past + i, one row
            # attends every key
            q, k, v = self._split(self.qkv_proj(x))
            past = cache[0].shape[1]
            k = torch.cat([cache[0].to(k.dtype), k], 1)
            v = torch.cat([cache[1].to(v.dtype), v], 1)
            mask = None
            if s > 1:
                ar = torch.arange(past + s, device=x.device)
                seen = ar[None, :] <= past + ar[:s, None]
                mask = torch.where(seen, 0.0, _NEG_INF)[None, None].to(
                    torch.float32)
            out = scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=False,
                dropout_p=self.dropout_p if self.training else 0.0,
                training=self.training, use_flash=self.use_flash)
            return self.out_proj(out.reshape(b, s, h)), (k, v)
        qkv = self.qkv_proj(x)
        if self._packed_flash_ok(qkv, s):
            # flash attention on the projection-native packed layout
            out = flash_attention_qkv_packed(
                qkv, self.num_heads, causal=True,
                dropout_p=self.dropout_p if self.training else 0.0)
            return self.out_proj(out)
        # the heads as (b, s, H, D) views; SDPA dispatches as in JAX
        q, k, v = self._split(qkv)
        out = scaled_dot_product_attention(
            q, k, v, is_causal=True,
            dropout_p=self.dropout_p if self.training else 0.0,
            training=self.training, use_flash=self.use_flash)
        return self.out_proj(out.reshape(b, s, h))


class GPTMLP(Layer):
    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        kw = {"weight_attr": _normal_attr(config), "device": device,
              "dtype": dtype}
        self.fc_in = Linear(config.hidden_size, config.ffn_size, **kw)
        self.fc_out = Linear(config.ffn_size, config.hidden_size, **kw)

    def forward(self, x):
        return self.fc_out(gelu(self.fc_in(x), approximate=True))


class GPTBlock(Layer):
    """Pre-LN transformer block."""

    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        self.ln_1 = LayerNorm(config.hidden_size, device=device, dtype=dtype)
        self.attn = GPTAttention(config, device=device, dtype=dtype)
        self.ln_2 = LayerNorm(config.hidden_size, device=device, dtype=dtype)
        self.mlp = GPTMLP(config, device=device, dtype=dtype)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, x, cache=None, cache_pos=None, page_table=None):
        attn_out = self.attn(self.ln_1(x), cache=cache, cache_pos=cache_pos,
                             page_table=page_table)
        if cache is not None:
            attn_out, cache = attn_out
        x = x + self.dropout(attn_out)
        x = x + self.dropout(self.mlp(self.ln_2(x)))
        return x if cache is None else (x, cache)


class GPTModel(Layer):
    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        self.config = config
        kw = {"device": device, "dtype": dtype}
        self.wte = Embedding(config.vocab_size, config.hidden_size,
                             weight_attr=_normal_attr(config), **kw)
        self.wpe = Embedding(config.max_position_embeddings,
                             config.hidden_size,
                             weight_attr=_normal_attr(config), **kw)
        self.drop = Dropout(config.hidden_dropout_prob)
        self.blocks = LayerList([GPTBlock(config, **kw)
                                 for _ in range(config.num_layers)])
        self.ln_f = LayerNorm(config.hidden_size, **kw)

    def forward(self, input_ids, position_ids=None, caches=None,
                cache_pos=None, page_table=None):
        s = input_ids.shape[1]
        if cache_pos is not None or position_ids is None:
            # positions from the write offset (a growing cache's past
            # length, 0 without a cache), clipped to the table like the
            # reference's out-of-range gather; as in the reference, a
            # cache_pos decides them even where position_ids is given
            past = caches[0][0].shape[1] \
                if caches is not None and page_table is None else 0
            pos = cache_pos if cache_pos is not None else \
                torch.tensor(past, device=input_ids.device)
            position_ids = _positions(pos, s, self.wpe.weight.shape[0])
        x = self.drop(self.wte(input_ids) + self.wpe(position_ids))
        new_caches = []
        for i, block in enumerate(self.blocks):
            if caches is None:
                x = block(x)
            else:
                x, c = block(x, cache=caches[i], cache_pos=cache_pos,
                             page_table=page_table)
                new_caches.append(c)
        x = self.ln_f(x)
        return x if caches is None else (x, new_caches)

    def gen_empty_caches(self, batch_size, dtype="float32"):
        """One empty ``(batch_size, 0, H, D)`` K/V pair a layer, on the
        model's device: the growing cache of the reference's eager decode,
        which each forward returns one step longer."""
        cfg = self.config
        shape = (batch_size, 0, cfg.num_heads,
                 cfg.hidden_size // cfg.num_heads)
        kw = dict(dtype=convert_dtype(dtype), device=self.wte.weight.device)
        return [(torch.zeros(shape, **kw), torch.zeros(shape, **kw))
                for _ in range(cfg.num_layers)]


class GPTForCausalLM(Layer):
    """LM head ties the embedding matrix.  ``device=None`` means the CUDA
    card (a ``RuntimeError`` when there is none); pass ``device="cpu"`` for
    the plain path.  Weights start Normal(0, ``initializer_range``) from
    the device's default generator (biases 0, layer-norm scales 1); load
    trained or shared weights with ``utils.convert.load_jax_state``."""

    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        if config.moe_num_experts > 0:
            raise NotImplementedError(
                "GPT-MoE is not ported yet: ROADMAP Queue 1 item 11")
        dev = resolve_device(device)
        self.config = config
        self.gpt = GPTModel(config, device=dev,
                            dtype=None if dtype is None
                            else convert_dtype(dtype))

    @property
    def device(self) -> torch.device:
        return self.gpt.wte.weight.device

    def forward(self, input_ids, position_ids=None, caches=None,
                cache_pos=None, page_table=None):
        hidden = self.gpt(input_ids, position_ids, caches=caches,
                          cache_pos=cache_pos, page_table=page_table)
        if caches is not None:
            hidden, caches = hidden
        logits = hidden @ self.gpt.wte.weight.T
        return logits if caches is None else (logits, caches)

    def loss(self, input_ids, labels, position_ids=None):
        """Mean token cross entropy of the logits against ``labels``."""
        logits = self(input_ids, position_ids)
        return cross_entropy(logits.reshape(-1, self.config.vocab_size),
                             labels.reshape(-1))

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    @staticmethod
    def _nucleus_mask(scaled, top_p):
        """Mask logits outside the nucleus: keep the smallest set of tokens
        whose probability mass reaches ``top_p`` (the top-1 token is always
        kept).  ``top_p`` is a float or a broadcastable (B, 1) tensor."""
        probs = torch.softmax(scaled, -1)
        desc = probs.sort(-1, descending=True).values
        csum = desc.cumsum(-1)
        if isinstance(top_p, torch.Tensor):
            thresh = top_p.clamp_min(1e-9)
        else:
            thresh = max(float(top_p), 1e-9)
        keep = (csum - desc) < thresh
        kth = keep.sum(-1, keepdim=True)                    # >= 1 per row
        minp = desc.gather(-1, kth - 1)
        return scaled.masked_fill(probs < minp, _NEG_INF)

    @staticmethod
    def _sample(last, temperature, top_k, generator=None, top_p=None):
        """Greedy / temperature / top-k / nucleus sampling for every decode
        path.  Scalar mode (python-number ``temperature``): one config for
        the batch.  Vector mode ((B,) tensors ``temperature``/``top_k``/
        ``top_p``): each row under its own config, ``top_k=0`` /
        ``top_p=1.0`` disable that filter, ``temperature=0`` is greedy.
        Greedy is the argmax of the f32 ``logits / 1e-6`` in both modes, as
        in the JAX package, so it is token-exact against it.  Draws come
        from ``generator`` (default: the device's, ``core/random.py``).
        Returns (B, 1) int64."""
        last = last.float()
        if isinstance(temperature, (int, float)):
            last = last / max(temperature, 1e-6)
            if top_k is not None:
                cutoff = last.topk(top_k, -1).values[:, -1:]
                last = last.masked_fill(last < cutoff, _NEG_INF)
            if top_p is not None:
                last = GPTForCausalLM._nucleus_mask(last, float(top_p))
            if temperature == 0.0:
                return last.argmax(-1, keepdim=True)
            gen = generator or default_generator(last.device)
            return torch.multinomial(torch.softmax(last, -1), 1,
                                     generator=gen)
        temperature = temperature.float()
        scaled = last / temperature.clamp_min(1e-6)[:, None]
        greedy = scaled.argmax(-1, keepdim=True)
        if top_k is not None:
            kk = top_k.to(torch.long)
            vocab = scaled.shape[-1]
            desc = scaled.sort(-1, descending=True).values
            cut = desc.gather(-1, (kk - 1).clamp(0, vocab - 1)[:, None])
            scaled = scaled.masked_fill((kk > 0)[:, None] & (scaled < cut),
                                        _NEG_INF)
        if top_p is not None:
            scaled = GPTForCausalLM._nucleus_mask(
                scaled, top_p.float()[:, None])
        gen = generator or default_generator(last.device)
        sampled = torch.multinomial(torch.softmax(scaled, -1), 1,
                                    generator=gen)
        return torch.where((temperature == 0.0)[:, None], greedy, sampled)

    @torch.inference_mode()
    def generate(self, input_ids, max_new_tokens=32, temperature=1.0,
                 top_k: Optional[int] = None, jit_decode: bool = True,
                 top_p: Optional[float] = None, spec_k: int = 0,
                 drafter=None, *, generator=None):
        """Greedy / top-k / nucleus decoding over a static
        ``(B, prompt + max_new, H, D)`` KV cache: one prefill forward, then
        one width-1 forward per token.  ``input_ids`` is a (B, prompt)
        array or tensor; returns (B, prompt + max_new) int64 on the model's
        device.  Greedy output is token-exact against the JAX package's
        ``generate(temperature=0.0)``.  The parameters are the reference's,
        in its order; ``jit_decode`` chooses between two JAX programs that
        give the same tokens, so either value runs this one eager loop
        (the reference's growing cache is the forward over
        ``GPTModel.gen_empty_caches``).  ``generator`` (keyword only, the
        port's own) draws the samples; default: the device's default
        generator.

        ``spec_k > 0`` switches to speculative draft-and-verify decoding
        (:meth:`_generate_spec`): a drafter (``drafter='ngram'``
        prompt-lookup by default, or a small ``GPTForCausalLM``) proposes
        up to ``spec_k`` tokens a step and one forward of width
        ``spec_k + 1`` verifies them, committing the longest prefix that
        matches the model's greedy argmax, so the output equals the
        non-speculative greedy output token for token.  Greedy only
        (``temperature`` must be 0.0), as in the reference."""
        self.eval()
        dev = self.device
        ids = torch.as_tensor(np.asarray(input_ids), device=dev).long() \
            if not isinstance(input_ids, torch.Tensor) \
            else input_ids.to(dev).long()
        if spec_k:
            if temperature != 0.0:
                raise ValueError(
                    "spec_k requires temperature=0.0: speculative "
                    "acceptance matches the target's greedy argmax, so "
                    "only greedy decoding is exactly preserved")
            if not jit_decode:
                raise ValueError(
                    "spec_k requires jit_decode=True: the draft-and-"
                    "verify loop runs over the static-cache forwards "
                    "(the growing-cache path has no verify step)")
            return self._generate_spec(ids, max_new_tokens, int(spec_k),
                                       drafter)
        if max_new_tokens <= 0:
            return ids
        b, prompt = ids.shape
        max_len = prompt + max_new_tokens
        caches = self._static_caches(b, max_len)
        out: List[torch.Tensor] = []
        logits, caches = self(ids, caches=caches,
                              cache_pos=torch.tensor(0, device=dev))
        nxt = self._sample(logits[:, -1], temperature, top_k, generator,
                           top_p=top_p)
        out.append(nxt)
        for t in range(max_new_tokens - 1):
            logits, caches = self(nxt, caches=caches,
                                  cache_pos=torch.tensor(prompt + t,
                                                         device=dev))
            nxt = self._sample(logits[:, -1], temperature, top_k, generator,
                               top_p=top_p)
            out.append(nxt)
        return torch.cat([ids] + out, 1)

    def _static_caches(self, b, max_len):
        """One zeroed ``(b, max_len, H, D)`` K/V pair a layer in the
        model's dtype, on its device."""
        cfg = self.config
        head_dim = cfg.hidden_size // cfg.num_heads
        w = self.gpt.wte.weight
        return [(w.new_zeros(b, max_len, cfg.num_heads, head_dim),
                 w.new_zeros(b, max_len, cfg.num_heads, head_dim))
                for _ in range(cfg.num_layers)]

    def _generate_spec(self, ids, max_new_tokens, spec_k, drafter):
        """Speculative draft-and-verify greedy decoding (the reference's
        host loop): a prompt prefill and a width-(K+1) VERIFY forward
        that scores every proposal position at once over one static
        cache of ``prompt + max_new`` rows, plus a host loop
        that proposes drafts, accepts the longest argmax-matching prefix,
        and commits ``accepted + 1`` tokens a round trip.  Rejected tails
        need no cache rollback: attention reads only ``kpos <= qpos`` and
        the next verify rewrites ``[length, length + K]``, so stale rows
        are never attended (the serving engine's tick shares this
        invariant).  A row that has its tokens is frozen: it re-verifies
        in place and commits nothing.

        Output equals the greedy non-speculative ``generate``: both
        commit ``argmax(logits / 1e-6)`` given the same committed prefix.
        Acceptance counters land on ``self._last_spec_stats``
        (``{"proposed", "accepted", "ticks"}``), ``proposed`` and
        ``accepted`` capped at each row's remaining budget."""
        if max_new_tokens <= 0:
            return ids
        dev = self.device
        b, prompt = ids.shape
        K = int(spec_k)
        # the target's cache has the non-spec length, so that every
        # forward attends over as many rows as the non-spec loop's and
        # rounds alike on the card (the reference adds K+1 rows for the
        # verify's tail; here a write past the end lands in the last row,
        # T - 1: GPTAttention).  No kept token reads that row: the last
        # committed token is sampled at position T - 2, and every query
        # past it is discarded.  The drafter's mirror
        # keeps the reference's K+1 extra rows
        caches = self._static_caches(b, prompt + max_new_tokens)
        cache_len = prompt + max_new_tokens + K + 1

        # one resolved drafter per (drafter, K), as the reference keeps
        # it: repeated calls with one draft model reuse one ModelDrafter.
        # The entry keeps a strong ref to the caller's argument, so the
        # id() key cannot alias a recycled object.
        dcache = self.__dict__.setdefault("_spec_drafter_cache", {})
        entry = dcache.get((id(drafter), K))
        if entry is None or entry[0] is not drafter:
            if len(dcache) >= 8:
                dcache.pop(next(iter(dcache)))
            entry = (drafter, get_drafter(drafter, K))
            dcache[(id(drafter), K)] = entry
        dr = entry[1]
        dr.begin(b, cache_len)
        # explicit fetches (device_get): one for the prompt mirror, one
        # per verify round trip
        np_ids = device_get(ids).astype(np.int32)
        dr.ingest(np_ids, np.zeros(b, np.int32),
                  np.full(b, prompt, np.int32))
        logits, caches = self(ids, caches=caches,
                              cache_pos=torch.tensor(0, device=dev))
        tok0 = device_get(self._sample(logits[:, -1], 0.0, None)[:, 0]
                          .to(torch.int32))
        out = np.zeros((b, max_new_tokens), np.int32)
        out[:, 0] = tok0
        ngen = np.ones(b, np.int64)
        lengths = np.full(b, prompt, np.int32)  # committed cache rows
        last = tok0.copy()
        stats = {"proposed": 0, "accepted": 0, "ticks": 0}
        while (ngen < max_new_tokens).any():
            drafts, ndraft = dr.propose(last, lengths)
            ndraft = np.where(ngen >= max_new_tokens, 0, ndraft)
            toks = np.concatenate([last[:, None], drafts], axis=1)
            logits, caches = self(
                torch.as_tensor(toks, device=dev).long(), caches=caches,
                cache_pos=torch.as_tensor(lengths, device=dev))
            ver = device_get(self._sample(
                logits.reshape(b * (K + 1), -1), 0.0, None)[:, 0]
                .reshape(b, K + 1).to(torch.int32))
            acc = accept_lengths(drafts, ndraft, ver)
            stats["ticks"] += 1
            ingest_nvalid = np.zeros(b, np.int32)
            old_lengths = lengths.copy()
            for i in range(b):
                if ngen[i] >= max_new_tokens:
                    continue  # frozen: re-verifies in place, commits nothing
                rem = max_new_tokens - int(ngen[i])
                # cap at the row's remaining budget: drafts past it are
                # discarded, and counting them would overstate the
                # acceptance rate
                stats["proposed"] += min(int(ndraft[i]), rem)
                stats["accepted"] += min(int(acc[i]), rem)
                take = min(int(acc[i]) + 1, rem)
                out[i, ngen[i]:ngen[i] + take] = ver[i, :take]
                ngen[i] += take
                if ngen[i] < max_new_tokens:
                    ingest_nvalid[i] = int(acc[i]) + 1
                    lengths[i] += int(acc[i]) + 1
                    last[i] = ver[i, int(acc[i])]
            if getattr(dr, "ingest_after_verify", True):
                # self-ingesting drafters already wrote these rows in
                # propose(); replaying them would recompute identical KV
                dr.ingest(toks, old_lengths, ingest_nvalid)
        self._last_spec_stats = stats
        return torch.cat([ids, torch.as_tensor(out, device=dev).long()], 1)


def param_sharding_spec(name: str, shape) -> tuple:
    """Mesh-axis names for each dimension of a GPT parameter: the JAX
    package's tensor-parallel plan, Megatron style (qkv and fc_in split
    their output columns on ``"mp"``, out_proj and fc_out their input
    rows, the embedding its vocabulary rows; ZeRO-3's ``"sharding"`` on
    the embeddings' rows; MoE stacks on ``"ep"``), as plain tuples.  The
    port's train step takes it as its ``rule`` and places nothing with
    it on one device; a multi-device step is ROADMAP Queue 1 item 12."""
    if name.endswith(".weight_scale"):
        # weight-only scales follow their weight's output channels;
        # checked first, as "qkv_proj.weight" is a substring of the name
        if "qkv_proj." in name or "fc_in." in name:
            return ("mp",)
        return (None,)
    if "qkv_proj.weight" in name or "fc_in.weight" in name:
        return (None, "mp")
    if "out_proj.weight" in name or "fc_out.weight" in name:
        return ("mp", None)
    if "qkv_proj.bias" in name or "fc_in.bias" in name:
        return ("mp",)
    if ".mlp.w1" in name:
        return ("ep", None, "mp")
    if ".mlp.b1" in name:
        return ("ep", "mp")
    if ".mlp.w2" in name:
        return ("ep", "mp", None)
    if ".mlp.b2" in name:
        return ("ep", None)
    if ".mlp.gate.weight" in name:
        return (None, None)
    if "wte.weight" in name:
        return (("mp", "sharding"), None)
    if "wpe.weight" in name:
        return ("sharding", None)
    return tuple(None for _ in shape)
