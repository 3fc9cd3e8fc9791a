"""Post-training weight-only quantization for serving: the port of the JAX
package's ``nn/quant/weight_only.py``.

Weights are STORED as int8 (or fp8-e4m3) with one f32 scale per output
channel and widened inside the GEMM
(``incubate/nn/kernels/quant_matmul.py``, the kernel K4 on the card);
activations stay bf16.  Scale convention: symmetric absmax per OUTPUT
channel, no zero point.

- :func:`quantize_weights`: a name-keyed dict of tensors -> each matching
  2-D weight becomes its narrow tensor plus a ``<name>_scale`` f32 entry
  (what ``save_for_serving(..., quant=...)`` writes).
- :class:`WeightOnlyLinear`: the serving layer, a drop-in for
  ``nn.Linear`` whose forward runs ``quant_matmul``.
- :func:`apply_weight_only`: swap a live model's Linears (in place), or
  install empty shells at an artifact's manifest paths (what
  ``load_for_serving`` does before it loads state).

- :func:`convert_to_weight_only`: the QAT export, every
  ``QuantizedLinear`` of a tree swapped for a :class:`WeightOnlyLinear` on
  the grid training simulated (``WeightOnlyLinear.from_qat``).

:func:`quantize_array` gives the JAX package's bits: f32 ``absmax /
qmax`` floored at 1e-9, an f32 division, round half to even (int8),
clip, cast.
"""

from __future__ import annotations

import torch
from torch import nn

from ...incubate.nn.kernels.quant_matmul import quant_matmul
from ..layers.common import Linear
from .quant_layers import QuantizedLinear, channel_absmax

__all__ = [
    "quantize_weights", "quantize_array", "WeightOnlyLinear",
    "apply_weight_only", "convert_to_weight_only", "resolve_scheme",
    "default_quant_predicate",
]

SCHEMES = ("int8", "fp8-e4m3")


def resolve_scheme(scheme):
    """Normalise a scheme name (``"fp8"`` -> ``"fp8-e4m3"``)."""
    if scheme is None:
        return None
    if scheme == "fp8":
        scheme = "fp8-e4m3"
    if scheme not in SCHEMES:
        raise ValueError(
            f"unknown weight-only scheme {scheme!r}; expected one of "
            f"{SCHEMES} (or 'fp8')")
    return scheme


def _qmax(scheme):
    # int8: symmetric [-127, 127]; e4m3: largest finite magnitude
    return 127.0 if scheme == "int8" else 448.0


def _qdtype(scheme):
    return torch.int8 if scheme == "int8" else torch.float8_e4m3fn


@torch.no_grad()
def quantize_array(w, scheme="int8", axis=-1, absmax=None):
    """Quantize one weight: returns ``(w_q, scale)`` with ``scale`` f32 per
    channel over ``axis`` (default last: the output channels of the
    ``(in, out)`` Linear layout).  ``absmax`` supplies a learned
    per-channel statistic instead of measuring the tensor."""
    scheme = resolve_scheme(scheme)
    w = torch.as_tensor(w).detach()
    axis = axis % w.dim()
    if absmax is None:
        absmax = channel_absmax(w, axis)
    qmax = _qmax(scheme)
    # dead channels (absmax 0) would divide by zero; their rows are all
    # zero anyway, so any positive scale reproduces them exactly
    scale = torch.clamp_min(
        torch.as_tensor(absmax, device=w.device).to(torch.float32) / qmax,
        1e-9)
    shape = [1] * w.dim()
    shape[axis] = scale.shape[0]
    q = w.to(torch.float32) / scale.reshape(shape)
    if scheme == "int8":
        q = torch.clamp(torch.round(q), -qmax, qmax).to(torch.int8)
    else:
        q = torch.clamp(q, -qmax, qmax).to(_qdtype(scheme))
    return q, scale


def default_quant_predicate(name, arr):
    """Which params the serving quantizer touches by default: 2-D float
    matmul weights (the attention/MLP projections), NOT embeddings
    (``wte``/``wpe``: gathers, and the tied ``wte`` is also the logits
    head, which stays in the float dtype).  ``arr`` is a tensor."""
    if not name.endswith(".weight") or arr.dim() != 2:
        return False
    # itemsize 1 excludes fp8 (a floating type) beside int8: an
    # already-quantized weight must never quantize twice
    if not arr.dtype.is_floating_point or arr.element_size() == 1:
        return False
    lowered = name.lower()
    return not any(t in lowered for t in ("wte", "wpe", "embed"))


def quantize_weights(params, scheme="int8", predicate=None):
    """Post-training quantize a name-keyed dict of tensors.  Returns
    ``(new_params, manifest)``: each quantized entry replaced by its narrow
    tensor plus an added ``<name>_scale`` f32 entry, and ``manifest`` the
    quantized names (recorded in the artifact's ``config.json`` so the
    loader knows which Linears to swap)."""
    scheme = resolve_scheme(scheme)
    predicate = predicate or default_quant_predicate
    out, manifest = {}, []
    for name, arr in params.items():
        if predicate(name, arr):
            q, scale = quantize_array(arr, scheme)
            out[name] = q
            out[name + "_scale"] = scale
            manifest.append(name)
        else:
            out[name] = arr
    return out, manifest


class WeightOnlyLinear(nn.Module):
    """Serving Linear over a quantized weight: ``weight`` is int8 /
    fp8-e4m3 ``(in, out)``, ``weight_scale`` the f32 per-output-channel
    scale; both are parameters that take no gradient, so the state names
    are the JAX package's (``<path>.weight``, ``<path>.weight_scale``).
    Forward runs ``quant_matmul`` (K4 on a CUDA tensor, its plain version
    on a CPU one).  Inference only."""

    def __init__(self, in_features, out_features, scheme="int8",
                 has_bias=True, device=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.scheme = resolve_scheme(scheme)
        self.weight = nn.Parameter(
            torch.zeros(in_features, out_features, device=device,
                        dtype=_qdtype(self.scheme)), requires_grad=False)
        self.weight_scale = nn.Parameter(
            torch.ones(out_features, device=device, dtype=torch.float32),
            requires_grad=False)
        self.bias = nn.Parameter(
            torch.zeros(out_features, device=device),
            requires_grad=False) if has_bias else None

    def forward(self, x):
        return quant_matmul(x, self.weight, self.weight_scale, self.bias)

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}, scheme={self.scheme}")

    @torch.no_grad()
    def _load_quantized(self, w_q, scale):
        if tuple(scale.shape) != (self.out_features,):
            # the layer's contract is ONE scale per output channel
            raise ValueError(
                f"weight_scale must be per-output-channel "
                f"({self.out_features},); got {tuple(scale.shape)}")
        self.weight.copy_(w_q)
        self.weight_scale.copy_(scale)
        return self

    @classmethod
    def from_linear(cls, linear, scheme="int8"):
        """Quantize a live ``Linear`` (measured absmax scales).  The bias
        parameter is SHARED, not copied."""
        w = linear.weight.detach()
        q, scale = quantize_array(w, scheme, axis=-1)
        lay = cls(w.shape[0], w.shape[1], scheme=scheme, has_bias=False,
                  device=w.device)
        lay.bias = linear.bias
        return lay._load_quantized(q, scale)

    @classmethod
    def from_qat(cls, qlayer, scheme="int8"):
        """Convert a QAT ``QuantizedLinear`` with its LEARNED absmax (the
        ``_fake_quant_weight.scale`` buffer), so serving quantizes on the
        grid training simulated: per channel from a
        ``channel_wise_abs_max`` quantizer, or the per-tensor ``abs_max``
        scalar broadcast over the output channels.  A quantizer that never
        ran (all-zero scale) falls back to measuring the weight.  The bias
        parameter is SHARED."""
        w = qlayer.weight.detach()
        out = w.shape[1]
        fq = qlayer._fake_quant_weight
        quant_axis = getattr(fq, "_quant_axis", None)
        if quant_axis is not None and quant_axis % w.dim() != w.dim() - 1:
            # per-IN-channel scales cannot leave the GEMM as a per-output
            # epilogue (and for a square weight a shape check would not
            # notice), so refuse with the remedy
            raise ValueError(
                f"convert_to_weight_only needs per-OUTPUT-channel QAT "
                f"scales (weight_quant_axis={w.dim() - 1}); this layer "
                f"learned quant_axis={quant_axis}.  Re-run QAT with "
                f"weight_quant_axis={w.dim() - 1} or quantize from the "
                f"weights instead (apply_weight_only / "
                f"save_for_serving(quant=...)).")
        absmax = fq.scale.detach()
        if not bool((absmax > 0).any()):
            absmax = None
        elif quant_axis is None:
            # per-tensor observer: one scalar, the same grid on every
            # output channel
            absmax = absmax.reshape(-1)[:1].expand(out)
        q, scale = quantize_array(w, scheme, axis=-1, absmax=absmax)
        lay = cls(w.shape[0], w.shape[1], scheme=scheme, has_bias=False,
                  device=w.device)
        lay.bias = qlayer.bias
        return lay._load_quantized(q, scale)


def _shell_for(old, scheme):
    """An empty quantized layer in ``old``'s place, sharing its bias."""
    w = old.weight
    lay = WeightOnlyLinear(w.shape[0], w.shape[1], scheme=scheme,
                           has_bias=False, device=w.device)
    lay.bias = old.bias
    return lay


def apply_weight_only(model, scheme="int8", names=None):
    """Swap a live model's ``Linear``s for :class:`WeightOnlyLinear`.

    ``names=None`` quantizes in place every ``Linear`` whose weight passes
    :func:`default_quant_predicate` on its real dotted path (measured
    scales).  ``names``, an artifact manifest of ``<path>.weight`` entries,
    instead installs EMPTY quantized shells at exactly those paths, for the
    loader to fill (the wide weights are never rebuilt).  Returns the
    number of layers swapped."""
    scheme = resolve_scheme(scheme)
    swapped = 0
    if names is not None:
        for pname in names:
            path = pname[:-len(".weight")].split(".")
            parent = model.get_submodule(".".join(path[:-1]))
            setattr(parent, path[-1],
                    _shell_for(getattr(parent, path[-1]), scheme))
            swapped += 1
        return swapped
    for lname, layer in list(model.named_modules()):
        for name, sub in list(layer.named_children()):
            full = f"{lname}.{name}.weight" if lname else f"{name}.weight"
            if type(sub) is Linear and default_quant_predicate(full,
                                                               sub.weight):
                setattr(layer, name,
                        WeightOnlyLinear.from_linear(sub, scheme))
                swapped += 1
    return swapped


def convert_to_weight_only(layer_tree, scheme="int8"):
    """QAT export: replace every ``QuantizedLinear`` in ``layer_tree`` with
    a :class:`WeightOnlyLinear` built from its learned scales
    (:meth:`WeightOnlyLinear.from_qat`).  In place; returns the number of
    layers converted.  The converted tree saves through
    ``save_for_serving`` like any quantized model (its weights are already
    narrow, so ``quant=`` is NOT passed again)."""
    converted = 0
    for layer in list(layer_tree.modules()):
        for name, sub in list(layer.named_children()):
            if isinstance(sub, QuantizedLinear):
                setattr(layer, name, WeightOnlyLinear.from_qat(sub, scheme))
                converted += 1
    return converted
