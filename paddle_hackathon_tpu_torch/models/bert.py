"""BERT / ERNIE encoder family: the port of the JAX package's
``models/bert.py``.

ERNIE shares BERT's architecture (other corpora and presets), so
``ErnieModel`` and its heads are the same classes.  Parameter names and
layouts are the JAX model's (``bert.encoder.0.attention.qkv_proj.weight``
of shape ``(in, out)``, ...), so a JAX ``state_dict()`` exported to numpy
loads name for name (``utils/convert.py``).

Self-attention is dispatched as in the JAX package
(:meth:`BertSelfAttention.forward`):

- no padding mask, bf16/f16 and ``_packed_flash_ok``: the packed-qkv
  flash kernels (K1, ``incubate/nn/kernels/flash_attention_packed.py``)
  with ``causal=False``;
- otherwise ``nn.functional.scaled_dot_product_attention``: the bhd flash
  kernels (K2) where flash is asked for and there is no mask (an f32
  encoder), the plain composition under a padding mask.

The padding mask is the JAX package's ``(b, 1, 1, s)`` f32 additive bias
(-1e30 on padded keys); on a bf16/f16 encoder it makes the masked
attention's output f32, and the rest of the forward follows in f32, as
JAX's type promotion does.

The MLM head decodes against the word embedding without registering it a
second time: ``state_dict()`` names the tied matrix once, as
``bert.embeddings.word_embeddings.weight``, and the head reads it from
the embedding layer at each forward (so ``functional_call``'s swapped
tensor is the one decoded against).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core import flags
from ..core.device import parameter_device, resolve_device
from ..core.dtype import convert_dtype
from ..core.tensor import takes_tensors
from ..incubate.nn.functional import flash_attention_qkv_packed
from ..incubate.nn.kernels import flash_attention_packed as _fap
from ..nn import functional as F
from ..nn import initializer as I
from ..nn.container import LayerList
from ..nn.layer import Layer
from ..nn.layers.common import Dropout, Embedding, Linear
from ..nn.layers.norm import LayerNorm
from ..nn.layers.transformer import SequenceParallelMixin, _sp_mask_check
from ..nn.parameter import ParamAttr, create_parameter

_DISTRIBUTED = "is not ported yet: ROADMAP Queue 1 item 12"


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: Optional[int] = None
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_dropout_prob: float = 0.1
    initializer_range: float = 0.02
    hidden_act: str = "gelu"
    # True by default, as in the JAX package: the encoder asks for the
    # flash kernels at every supported length.  None is the auto rule
    # (flash at s >= flash_attention_min_seqlen), False the plain
    # composition.
    use_flash_attention: bool = True

    @property
    def ffn_size(self):
        return self.intermediate_size or 4 * self.hidden_size


_PRESETS = {
    # name: (layers, hidden, heads, vocab, type_vocab)
    "bert-base-uncased": (12, 768, 12, 30522, 2),
    "bert-large-uncased": (24, 1024, 16, 30522, 2),
    "bert-base-chinese": (12, 768, 12, 21128, 2),
    "ernie-1.0": (12, 768, 12, 18000, 2),
    "ernie-3.0-base-zh": (12, 768, 12, 40000, 4),
    "ernie-3.0-medium-zh": (6, 768, 12, 40000, 4),
}


def bert_config(name: str, **overrides) -> BertConfig:
    layers, hidden, heads, vocab, tv = _PRESETS[name]
    act = "relu" if name.startswith("ernie-1") else "gelu"
    cfg = BertConfig(num_layers=layers, hidden_size=hidden, num_heads=heads,
                     vocab_size=vocab, type_vocab_size=tv, hidden_act=act)
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg


ernie_config = bert_config  # ERNIE presets share the module


def _normal_attr(config: BertConfig) -> ParamAttr:
    return ParamAttr(initializer=I.Normal(0.0, config.initializer_range))


class BertEmbeddings(Layer):
    """word + position + token-type embeddings, LN, dropout."""

    def __init__(self, config: BertConfig, device=None, dtype=None):
        super().__init__()
        kw = {"weight_attr": _normal_attr(config), "device": device,
              "dtype": dtype}
        self.word_embeddings = Embedding(config.vocab_size,
                                         config.hidden_size, **kw)
        self.position_embeddings = Embedding(config.max_position_embeddings,
                                             config.hidden_size, **kw)
        self.token_type_embeddings = Embedding(config.type_vocab_size,
                                               config.hidden_size, **kw)
        self.layer_norm = LayerNorm(config.hidden_size, device=device,
                                    dtype=dtype)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        b, s = input_ids.shape
        if position_ids is None:
            position_ids = torch.arange(s, device=input_ids.device).expand(
                b, s)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(x))


class BertSelfAttention(SequenceParallelMixin, Layer):
    def __init__(self, config: BertConfig, device=None, dtype=None):
        super().__init__()
        h = config.hidden_size
        kw = {"weight_attr": _normal_attr(config), "device": device,
              "dtype": dtype}
        self.num_heads = config.num_heads
        self.head_dim = h // config.num_heads
        self.qkv_proj = Linear(h, 3 * h, **kw)
        self.out_proj = Linear(h, h, **kw)
        self.dropout_p = config.attention_dropout_prob
        self.use_flash = config.use_flash_attention

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

    def forward(self, x, attn_mask=None):
        b, s, h = x.shape
        qkv = self.qkv_proj(x)
        if self._sp_enabled():
            _sp_mask_check(attn_mask)
            q, k, v = qkv.reshape(b, s, 3, self.num_heads,
                                  self.head_dim).unbind(2)
            out = self._sp_attention(q, k, v, causal=False)
            return self.out_proj(out.reshape(b, s, h))
        drop = self.dropout_p if self.training else 0.0
        if attn_mask is None and self._packed_flash_ok(qkv, s):
            # bidirectional flash attention on the packed projection
            out = flash_attention_qkv_packed(qkv, self.num_heads,
                                             causal=False, dropout_p=drop)
            return self.out_proj(out)
        q, k, v = qkv.reshape(b, s, 3, self.num_heads,
                              self.head_dim).unbind(2)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, is_causal=False, dropout_p=drop,
            training=self.training, use_flash=self.use_flash)
        return self.out_proj(out.reshape(b, s, h))


class BertLayer(Layer):
    """Post-LN encoder block (the original BERT layout; the reference's
    ``TransformerEncoderLayer`` with ``normalize_before=False``)."""

    def __init__(self, config: BertConfig, device=None, dtype=None):
        super().__init__()
        kw = {"weight_attr": _normal_attr(config), "device": device,
              "dtype": dtype}
        self.attention = BertSelfAttention(config, device=device,
                                           dtype=dtype)
        self.ln_1 = LayerNorm(config.hidden_size, device=device, dtype=dtype)
        self.fc_in = Linear(config.hidden_size, config.ffn_size, **kw)
        self.fc_out = Linear(config.ffn_size, config.hidden_size, **kw)
        self.ln_2 = LayerNorm(config.hidden_size, device=device, dtype=dtype)
        self.dropout = Dropout(config.hidden_dropout_prob)
        self.act = config.hidden_act

    def forward(self, x, attn_mask=None):
        x = self.ln_1(x + self.dropout(self.attention(x, attn_mask)))
        h = self.fc_in(x)
        h = F.gelu(h, approximate=True) if self.act == "gelu" else F.relu(h)
        return self.ln_2(x + self.dropout(self.fc_out(h)))


class BertPooler(Layer):
    def __init__(self, config: BertConfig, device=None, dtype=None):
        super().__init__()
        self.dense = Linear(config.hidden_size, config.hidden_size,
                            device=device, dtype=dtype)

    def forward(self, hidden):
        return torch.tanh(self.dense(hidden[:, 0]))


def _device_dtype(device, dtype):
    return resolve_device(device), \
        None if dtype is None else convert_dtype(dtype)


class BertModel(Layer):
    """Encoder trunk: embeddings -> N layers -> (sequence_output, pooled).
    ``device=None`` means the CUDA card (a ``RuntimeError`` when there is
    none); pass ``device="cpu"`` for the plain path."""

    def __init__(self, config: BertConfig, device=None, dtype=None):
        super().__init__()
        dev, dt = _device_dtype(device, dtype)
        self.config = config
        self.embeddings = BertEmbeddings(config, device=dev, dtype=dt)
        self.encoder = LayerList([BertLayer(config, device=dev, dtype=dt)
                                  for _ in range(config.num_layers)])
        self.pooler = BertPooler(config, device=dev, dtype=dt)

    @staticmethod
    def _additive_mask(attention_mask, device=None):
        """``[b, s]`` 1/0 padding mask -> ``[b, 1, 1, s]`` f32 additive
        bias (0 to keep, -1e30 to mask)."""
        if attention_mask is None:
            return None
        m = torch.as_tensor(attention_mask, device=device)
        keep = m[:, None, None, :] > 0
        return torch.where(keep, 0.0, -1e30).to(torch.float32)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        mask = self._additive_mask(attention_mask, input_ids.device)
        for layer in self.encoder:
            x = layer(x, mask)
        return x, self.pooler(x)


ErnieModel = BertModel


class BertLMPredictionHead(Layer):
    """MLM head: transform + decode tied to the word embedding.

    ``embeddings`` is the ``Embedding`` whose ``[vocab, hidden]`` weight
    the decoder is tied to, read at each forward and held unregistered,
    so the tie adds no name to ``state_dict()`` (the JAX head takes the
    weight itself).  ``decoder_bias`` is f32 whatever ``dtype`` is, and is
    cast to the rows' dtype when added."""

    def __init__(self, config: BertConfig, embeddings, device=None,
                 dtype=None):
        super().__init__()
        self.transform = Linear(config.hidden_size, config.hidden_size,
                                device=device, dtype=dtype)
        self.layer_norm = LayerNorm(config.hidden_size, device=device,
                                    dtype=dtype)
        object.__setattr__(self, "_embeddings", embeddings)
        self.decoder_bias = create_parameter(
            [config.vocab_size], "float32",
            default_initializer=I.Constant(0.0),
            device=self.transform.weight.device)

    @property
    def _decoder_weight(self):
        return self._embeddings.weight

    def forward(self, hidden, masked_positions=None):
        b, s, hh = hidden.shape
        if masked_positions is not None:
            # the MLM pretraining path: decode only the masked rows, flat
            # indices into (b*s) gathered before transform and decode
            idx = torch.as_tensor(masked_positions,
                                  device=hidden.device).reshape(-1).long()
            hidden = hidden.reshape(-1, hh).index_select(0, idx)
        h = self.layer_norm(F.gelu(self.transform(hidden), approximate=True))
        # decode on 2-D rows
        rows = F.linear(h.reshape(-1, hh), self._decoder_weight.T)
        rows = rows + self.decoder_bias.to(rows.dtype)
        if masked_positions is not None:
            return rows                                      # (K, vocab)
        return rows.reshape(b, s, -1)


class BertForPretraining(Layer):
    """MLM + NSP heads (the BERT/ERNIE-base pretraining configuration).
    ``device=None`` means the CUDA card (a ``RuntimeError`` when there is
    none); pass ``device="cpu"`` for the plain path."""

    def __init__(self, config: BertConfig, device=None, dtype=None):
        super().__init__()
        dev, dt = _device_dtype(device, dtype)
        self.config = config
        self.bert = BertModel(config, device=dev, dtype=dt)
        self.cls = BertLMPredictionHead(
            config, self.bert.embeddings.word_embeddings, device=dev,
            dtype=dt)
        self.nsp = Linear(config.hidden_size, 2, device=dev, dtype=dt)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                masked_positions=None):
        """``masked_positions`` (flat indices into b*s): MLM scores are
        returned for those rows only, ``(K, vocab)``; None returns full
        ``(b, s, vocab)`` scores.  Returns ``(mlm_scores, nsp_logits)``."""
        seq, pooled = self.bert(input_ids, token_type_ids,
                                attention_mask=attention_mask)
        return self.cls(seq, masked_positions=masked_positions), \
            self.nsp(pooled)

    @takes_tensors
    def loss(self, input_ids, mlm_labels, nsp_labels, token_type_ids=None,
             attention_mask=None, ignore_index: int = -100):
        """Masked-LM cross entropy (positions at ``ignore_index`` count
        zero) plus the NSP cross entropy."""
        pred, nsp_logits = self(input_ids, token_type_ids, attention_mask)
        labels = torch.as_tensor(mlm_labels, device=pred.device).reshape(-1)
        flat_logits = pred.reshape(-1, pred.shape[-1])
        valid = labels != ignore_index
        safe = torch.where(valid, labels, torch.zeros_like(labels))
        per_tok = F.cross_entropy(flat_logits, safe.to(torch.int32),
                                  reduction="none")
        w = valid.to(torch.float32)
        mlm_loss = (per_tok.reshape(-1) * w).sum() / torch.clamp_min(
            w.sum(), 1.0)
        nsp = torch.as_tensor(nsp_labels, device=pred.device)
        return mlm_loss + F.cross_entropy(nsp_logits, nsp)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())


class BertForSequenceClassification(Layer):
    """The pooled output through dropout and a ``num_classes`` linear.
    ``device=None`` means the CUDA card."""

    def __init__(self, config: BertConfig, num_classes: int = 2,
                 device=None, dtype=None):
        super().__init__()
        dev, dt = _device_dtype(device, dtype)
        self.bert = BertModel(config, device=dev, dtype=dt)
        self.dropout = Dropout(config.hidden_dropout_prob)
        self.classifier = Linear(config.hidden_size, num_classes,
                                 device=dev, dtype=dt)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids,
                              attention_mask=attention_mask)
        return self.classifier(self.dropout(pooled))


ErnieForSequenceClassification = BertForSequenceClassification
ErnieForPretraining = BertForPretraining


class BertMLMTransform(Layer):
    """The pre-decode half of the MLM head (transform + LN) as a
    standalone pipeline segment."""

    def __init__(self, config: BertConfig, device=None, dtype=None):
        super().__init__()
        self.transform = Linear(config.hidden_size, config.hidden_size,
                                device=device, dtype=dtype)
        self.layer_norm = LayerNorm(config.hidden_size, device=device,
                                    dtype=dtype)

    def forward(self, hidden):
        return self.layer_norm(
            F.gelu(self.transform(hidden), approximate=True))


class VocabBias(Layer):
    """Per-vocab f32 decoder bias, cast to the logits' dtype when added
    after the tied-embedding decode."""

    def __init__(self, vocab_size: int, device=None):
        super().__init__()
        self.bias = create_parameter([vocab_size], "float32",
                                     default_initializer=I.Constant(0.0),
                                     device=parameter_device(device))

    def forward(self, logits):
        return logits + self.bias.to(logits.dtype)


def _tied_mlm_decode(embeddings: BertEmbeddings, hidden):
    """Decode hidden states against the tied word-embedding weight (the
    pipeline's shared-weight head), on 2-D rows."""
    w = embeddings.word_embeddings.weight
    b, s, h = hidden.shape
    return F.linear(hidden.reshape(-1, h), w.T).reshape(b, s, -1)


def masked_mlm_loss(logits, labels, ignore_index: int = -100):
    """MLM cross entropy over the rows whose label is not
    ``ignore_index`` (``fused_softmax_ce_rows``, f32), their mean; the
    MLM term of ``BertForPretraining.loss``."""
    vocab = logits.shape[-1]
    flat = logits.reshape(-1, vocab)
    lab = labels.reshape(-1)
    valid = lab != ignore_index
    per_tok = F.fused_softmax_ce_rows(
        flat, torch.where(valid, lab, torch.zeros_like(lab)))
    w = valid.to(torch.float32)
    return torch.sum(per_tok * w) / torch.clamp_min(torch.sum(w), 1.0)


def bert_mlm_pipeline(config: BertConfig):
    """BERT/ERNIE MLM pretraining as a ``parallel.PipelineLayer``: the
    port has no pipeline layer yet."""
    raise NotImplementedError(
        f"bert_mlm_pipeline needs parallel/pipeline.py (PipelineLayer, "
        f"LayerDesc, SharedLayerDesc), which {_DISTRIBUTED}")


def bert_param_sharding_spec(name: str, shape) -> tuple:
    """Mesh-axis names per BERT parameter dimension (the JAX package's
    Megatron plan, as for GPT), as plain tuples; the port's one-device
    train step places nothing with it (ROADMAP Queue 1 item 12)."""
    if "qkv_proj.weight" in name or "fc_in.weight" in name:
        return (None, "mp")
    if "out_proj.weight" in name or "fc_out.weight" in name:
        return ("mp", None)
    if "qkv_proj.bias" in name or "fc_in.bias" in name:
        return ("mp",)
    if "word_embeddings.weight" in name:
        return ("mp", None)
    return tuple(None for _ in shape)
