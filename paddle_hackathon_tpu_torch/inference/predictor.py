"""The predictor (the JAX package's ``inference/predictor.py``).

Ref ``AnalysisPredictor`` (``paddle/fluid/inference/api/analysis_predictor.h:95``):
``ZeroCopyRun`` (``:182``), the input/output handles (``GetInputTensor``),
``PredictorPool`` (``api/paddle_inference_api.h``) and ``Clone``.

The artifact the port serves is a ``save_for_serving`` directory (bf16, or
int8/fp8 weight-only, saved by either package): it is rebuilt by
:func:`~.serving.load_for_serving` on the configured device and run as
``model(input_ids)`` under ``torch.no_grad()``, so a quantized artifact's
projections run the dequant GEMM (K4) and its attention the packed flash
kernel (K1) where their wrappers route them.  The weights stay on the
device; ``copy_from_cpu`` moves a feed there, outputs stay there until
``copy_to_cpu``: the ZeroCopy contract.  The JAX package's other two
artifact kinds, ``jit.save`` and ``static.save_inference_model`` programs,
are StableHLO exports, which torch cannot run: they raise.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from .config import Config

__all__ = ["Tensor", "Predictor", "create_predictor", "PredictorPool",
           "get_version"]


def get_version() -> str:
    from .. import __version__
    return __version__


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy; numpy has no bf16/fp8, so those widen to f32 (exact)."""
    t = t.detach().cpu()
    if t.dtype in (torch.bfloat16, torch.float8_e4m3fn):
        t = t.float()
    return t.numpy()


class Tensor:
    """Zero-copy input/output handle (ref ``ZeroCopyTensor``,
    ``paddle/fluid/inference/api/details/zero_copy_tensor.cc``)."""

    def __init__(self, name: str, device: torch.device):
        self.name = name
        self._device = device
        self._value: Optional[torch.Tensor] = None   # on the device
        self._shape_hint = None

    # -- input side --------------------------------------------------------
    def reshape(self, shape):
        """Declare the expected shape; checked on the next bind (shapes are
        otherwise taken from the bound array at run time)."""
        self._shape_hint = tuple(int(d) for d in shape)

    def copy_from_cpu(self, arr):
        arr = np.ascontiguousarray(arr)
        hint = self._shape_hint
        if hint is not None and tuple(arr.shape) != hint:
            raise ValueError(
                f"tensor '{self.name}': bound array shape {arr.shape} does "
                f"not match reshape({list(hint)})")
        self._value = torch.from_numpy(arr).to(self._device)

    def share_external_data(self, tensor):
        """Bind a tensor already on the predictor's device, without a
        copy."""
        if not isinstance(tensor, torch.Tensor):
            raise TypeError(f"tensor '{self.name}': share_external_data "
                            f"takes a torch.Tensor, got {type(tensor)}")
        if tensor.device != self._device:
            raise ValueError(
                f"tensor '{self.name}': shared data lies on "
                f"{tensor.device}, the predictor runs on {self._device}")
        self._value = tensor

    # -- output side -------------------------------------------------------
    def copy_to_cpu(self):
        if self._value is None:
            raise RuntimeError(f"tensor '{self.name}' has no data; run() "
                               f"first")
        return _to_numpy(self._value)

    def shape(self):
        return list(self._value.shape) if self._value is not None else []

    def type(self):
        return self._value.dtype if self._value is not None else None


class _BuildCtx:
    """Mutable context the pass pipeline operates on."""

    def __init__(self, config: Config):
        self.config = config
        self.donate_feeds = False
        self.resident_params = False
        self.optim_cache_dir = None


def _load_artifact(config: Config, device: torch.device):
    """The model of a ``save_for_serving`` directory, on ``device``.  The
    JAX package's ``.pdmodel`` programs (a ``jit.save`` zip or a static
    ``save_inference_model`` prefix) raise."""
    prog = config.prog_file()
    if prog is None:
        raise ValueError("Config has no model file; call set_model()")
    if os.path.isdir(prog) and os.path.exists(
            os.path.join(prog, "config.json")):
        from .serving import load_for_serving
        return load_for_serving(prog, device=device)
    path = prog if prog.endswith(".pdmodel") else prog + ".pdmodel"
    if os.path.exists(path):
        raise NotImplementedError(
            f"{path} is a StableHLO program (jit.save / static."
            f"save_inference_model), which torch cannot run; the port's "
            f"jit/ and static/ are not ported yet: ROADMAP Queue 1 item 13. "
            f"Serve a save_for_serving directory instead")
    raise FileNotFoundError(
        f"no serving artifact at {prog!r}: expected a save_for_serving "
        f"directory (config.json + params.npz)")


class Predictor:
    """Ref ``AnalysisPredictor`` (``analysis_predictor.h:95``)."""

    def __init__(self, config: Config, _shared=None):
        self._config = config
        ctx = _BuildCtx(config)
        if config.ir_optim():
            config.pass_builder().apply(ctx)
        self._ctx = ctx
        # the card or the CPU as the Config says: a Config that asks for
        # the card raises without one (no fallback)
        self._device = resolve_device(
            f"cuda:{config.gpu_device_id()}" if config.use_gpu() else "cpu")
        # clone(): the same model object (no second weight copy)
        self._model = (_shared if _shared is not None
                       else _load_artifact(config, self._device))
        self._model.eval()
        self._feed_names = ["input_ids"]
        self._inputs: Dict[str, Tensor] = {
            n: Tensor(n, self._device) for n in self._feed_names}
        self._outputs: Dict[str, Tensor] = {}
        self._output_names: List[str] = []

    # -- handles -----------------------------------------------------------
    def get_input_names(self) -> List[str]:
        return list(self._feed_names)

    def get_input_handle(self, name: str) -> Tensor:
        return self._inputs[name]

    get_input_tensor = get_input_handle

    def get_output_names(self) -> List[str]:
        if not self._output_names:
            self._output_names = ["fetch_0"]
        return list(self._output_names)

    def get_output_handle(self, name: str) -> Tensor:
        if name not in self._outputs:
            self._outputs[name] = Tensor(name, self._device)
        return self._outputs[name]

    get_output_tensor = get_output_handle

    # -- execution ---------------------------------------------------------
    def run(self, inputs: Optional[List] = None):
        """ZeroCopyRun (ref ``analysis_predictor.h:182``): the bound input
        handles in, the output handles filled (on the device), ``True``
        back.  With ``inputs`` given, the paddle_infer convenience API:
        binds them positionally and returns the outputs as numpy arrays
        (memory optim then releases the feeds)."""
        if inputs is not None:
            for name, arr in zip(self._feed_names, inputs):
                self._inputs[name].copy_from_cpu(np.asarray(arr))
        feeds = []
        for n in self._feed_names:
            h = self._inputs[n]
            if h._value is None:
                raise RuntimeError(f"input '{n}' not set; copy_from_cpu "
                                   f"first")
            feeds.append(h._value)
        with torch.no_grad():
            outs = [self._model(*feeds)]
        if inputs is not None and self._ctx.donate_feeds:
            # the feeds are released: a later zero-copy run() on the stale
            # handles gets the clear "not set" error
            for n in self._feed_names:
                self._inputs[n]._value = None
        self._output_names = [f"fetch_{i}" for i in range(len(outs))]
        for i, v in enumerate(outs):
            self.get_output_handle(self._output_names[i])._value = v
        if inputs is not None:
            return [_to_numpy(v) for v in outs]
        return True

    def clone(self) -> "Predictor":
        """A predictor with its own handles over the SAME model (no second
        weight copy), for another serving thread."""
        return Predictor(self._config, _shared=self._model)

    def clear_intermediate_tensor(self):
        for h in self._outputs.values():
            h._value = None


def create_predictor(config: Config) -> Predictor:
    """Ref ``CreatePaddlePredictor`` (``api/analysis_predictor.cc``)."""
    return Predictor(config)


class PredictorPool:
    """Ref ``PredictorPool`` (``api/paddle_inference_api.h``): one main
    predictor and ``size - 1`` clones sharing its model."""

    def __init__(self, config: Config, size: int = 1):
        main = create_predictor(config)
        self._preds = [main] + [main.clone() for _ in range(max(0, size - 1))]

    def retrieve(self, idx: int) -> Predictor:
        return self._preds[idx]
