"""paddle.nn.quant in the port: the QAT fake-quantization layers
(``quant_layers.py``), the functional-op layers QAT passes hook
(``functional_layers.py``), and the weight-only serving quantizer
(``weight_only.py``: post-training int8/fp8, or the QAT export
``convert_to_weight_only``, with the dequant GEMM K4)."""

from . import functional_layers  # noqa: F401
from .quant_layers import (FakeQuantAbsMax, FakeQuantChannelWiseAbsMax,
                           FakeQuantMAOutputScaleLayer,
                           FakeQuantMovingAverageAbsMax, MAOutputScaleLayer,
                           MovingAverageAbsMaxScale, QuantizedConv2D,
                           QuantizedConv2DTranspose, QuantizedLinear,
                           QuantStub, channel_absmax)
from .weight_only import (WeightOnlyLinear, apply_weight_only,
                          convert_to_weight_only, default_quant_predicate,
                          quantize_array, quantize_weights, resolve_scheme)

__all__ = ["FakeQuantAbsMax", "FakeQuantChannelWiseAbsMax",
           "FakeQuantMAOutputScaleLayer", "FakeQuantMovingAverageAbsMax",
           "MAOutputScaleLayer", "MovingAverageAbsMaxScale",
           "QuantizedConv2D", "QuantizedConv2DTranspose", "QuantizedLinear",
           "QuantStub", "WeightOnlyLinear", "apply_weight_only",
           "channel_absmax", "convert_to_weight_only",
           "default_quant_predicate", "functional_layers", "quantize_array",
           "quantize_weights", "resolve_scheme"]
