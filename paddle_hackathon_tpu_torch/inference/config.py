"""Inference ``Config`` and its pass pipeline (the JAX package's
``inference/config.py``).

Ref ``AnalysisConfig`` (``paddle/fluid/inference/api/analysis_config.cc``)
and ``PaddlePassBuilder`` (``api/paddle_pass_builder.h:38``).  The
reference rewrites a program with named IR passes before it runs; the
port's predictor runs a live model (a ``save_for_serving`` artifact
through ``load_for_serving``), whose kernels are chosen by their wrappers,
so a pass here sets a flag of the predictor's build context that
:class:`~.predictor.Predictor` reads, rather than rewriting a graph.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional


class PassBuilder:
    """Ordered, named pass pipeline (ref ``paddle_pass_builder.h:38``).

    A pass is ``name -> fn(build_ctx) -> None``, mutating the predictor's
    build context.  Users delete and insert passes as with the reference's
    ``config.pass_builder().DeletePass(...)``."""

    _registry: Dict[str, Callable] = {}

    def __init__(self, passes: Optional[List[str]] = None):
        self._passes: List[str] = list(passes) if passes is not None else [
            "donate_feed_buffers_pass",      # memory optim: release feeds
            "persistent_cache_pass",         # optim cache dir (recorded)
            "resident_params_pass",          # weights stay on the device
        ]

    @classmethod
    def register(cls, name: str):
        def deco(fn):
            cls._registry[name] = fn
            return fn
        return deco

    def all_passes(self) -> List[str]:
        return list(self._passes)

    def append_pass(self, name: str):
        self._passes.append(name)

    def insert_pass(self, idx: int, name: str):
        self._passes.insert(idx, name)

    def delete_pass(self, name: str):
        self._passes = [p for p in self._passes if p != name]

    def apply(self, ctx) -> None:
        for name in self._passes:
            fn = self._registry.get(name)
            if fn is not None:
                fn(ctx)


class Config:
    """Ref ``AnalysisConfig`` (``api/analysis_config.cc``).

    The device knobs pick the CUDA card (``enable_use_gpu``, the default;
    ``enable_tpu`` is kept for API parity as another name for the
    accelerator) or the CPU (``disable_gpu``).  A predictor built from a
    ``Config`` that asks for the card raises when there is none: there is
    no fallback to the CPU.  ``enable_memory_optim`` releases the feed
    tensors after a convenience ``run(inputs)``."""

    def __init__(self, prog_file: Optional[str] = None,
                 params_file: Optional[str] = None):
        self._prog_file = prog_file
        self._params_file = params_file
        self._use_device = "cuda"
        self._device_id = 0
        self._memory_optim = False
        self._ir_optim = True
        self._cpu_math_threads = 1
        self._optim_cache_dir: Optional[str] = None
        self._profile = False
        self._glog_info = True
        self._pass_builder = PassBuilder()
        self._exec_stream = None  # API parity: kernels take the current stream

    # -- model location ----------------------------------------------------
    def set_model(self, prog_file: str, params_file: Optional[str] = None):
        self._prog_file = prog_file
        self._params_file = params_file

    def set_prog_file(self, f: str):
        self._prog_file = f

    def set_params_file(self, f: str):
        self._params_file = f

    def prog_file(self) -> Optional[str]:
        return self._prog_file

    def params_file(self) -> Optional[str]:
        return self._params_file

    # -- device ------------------------------------------------------------
    def enable_use_gpu(self, memory_pool_init_size_mb: int = 100,
                       device_id: int = 0):
        self._use_device = "cuda"
        self._device_id = device_id

    def enable_tpu(self, device_id: int = 0):
        # the reference's accelerator knob, kept for API parity: the card
        self._use_device = "cuda"
        self._device_id = device_id

    def disable_gpu(self):
        self._use_device = "cpu"

    def use_gpu(self) -> bool:
        return self._use_device == "cuda"

    def gpu_device_id(self) -> int:
        return self._device_id

    # -- optimisation knobs -------------------------------------------------
    def enable_memory_optim(self, x: bool = True):
        self._memory_optim = x

    def enable_memory_optim_(self):  # C++-style spelling
        self._memory_optim = True

    def memory_optim_enabled(self) -> bool:
        return self._memory_optim

    def switch_ir_optim(self, x: bool = True):
        self._ir_optim = x

    def ir_optim(self) -> bool:
        return self._ir_optim

    def set_cpu_math_library_num_threads(self, n: int):
        self._cpu_math_threads = n

    def cpu_math_library_num_threads(self) -> int:
        return self._cpu_math_threads

    def set_optim_cache_dir(self, d: str):
        self._optim_cache_dir = d

    # -- diagnostics ---------------------------------------------------------
    def enable_profile(self):
        self._profile = True

    def disable_glog_info(self):
        self._glog_info = False

    def glog_info_disabled(self) -> bool:
        return not self._glog_info

    def pass_builder(self) -> PassBuilder:
        return self._pass_builder

    def summary(self) -> str:
        rows = [
            ("model_file", self._prog_file),
            ("params_file", self._params_file),
            ("device", f"{self._use_device}:{self._device_id}"),
            ("memory_optim", self._memory_optim),
            ("ir_optim", self._ir_optim),
            ("cpu_math_threads", self._cpu_math_threads),
            ("optim_cache_dir", self._optim_cache_dir),
            ("passes", ",".join(self._pass_builder.all_passes())),
        ]
        w = max(len(k) for k, _ in rows)
        return "\n".join(f"{k.ljust(w)}  {v}" for k, v in rows)


# the reference aliases AnalysisConfig == Config in paddle.inference
AnalysisConfig = Config


# ---------------------------------------------------------------------------
# built-in passes
# ---------------------------------------------------------------------------

@PassBuilder.register("donate_feed_buffers_pass")
def _donate_feed_buffers_pass(ctx):
    """The memory-optim pass (ref ``analysis/passes/memory_optimize_pass``):
    with memory optim on, a convenience ``run(inputs)`` releases its feed
    tensors once the outputs exist (the handles then read as unset)."""
    if ctx.config.memory_optim_enabled():
        ctx.donate_feeds = True


@PassBuilder.register("persistent_cache_pass")
def _persistent_cache_pass(ctx):
    """The reference serialises the optimised program (or a TensorRT
    engine) into ``set_optim_cache_dir``.  The port compiles no program per
    predictor (its kernels are built once per process by their wrappers),
    so there is nothing to cache: the pass records the directory on the
    build context and does nothing else.  ``summary()`` shows it."""
    ctx.optim_cache_dir = ctx.config._optim_cache_dir


@PassBuilder.register("resident_params_pass")
def _resident_params_pass(ctx):
    """Weights stay on the device: the predictor loads its model onto the
    configured device once and every run reads it there.  As in the JAX
    package for a ``save_for_serving`` artifact, the live model holds the
    only weight copy, so the flag changes no placement; it is recorded on
    the build context."""
    ctx.resident_params = True
