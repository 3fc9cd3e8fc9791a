"""paddle.nn.quant in the port: the weight-only serving quantizer
(``weight_only.py``, post-training int8/fp8 with the dequant GEMM K4) and
the channel statistic it shares with the QAT layers (``quant_layers.py``;
the QAT layers themselves are not ported yet)."""

from .quant_layers import channel_absmax
from .weight_only import (WeightOnlyLinear, apply_weight_only,
                          convert_to_weight_only, default_quant_predicate,
                          quantize_array, quantize_weights, resolve_scheme)

__all__ = ["WeightOnlyLinear", "apply_weight_only", "channel_absmax",
           "convert_to_weight_only", "default_quant_predicate",
           "quantize_array", "quantize_weights", "resolve_scheme"]
