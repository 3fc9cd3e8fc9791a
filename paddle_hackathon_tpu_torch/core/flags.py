"""Global flag registry (the JAX package's ``core/flags.py``).

A plain in-process registry seeded from ``FLAGS_*`` environment variables
at import time, with the JAX package's names and defaults for the flags
the port reads.  The lock is a plain ``threading.RLock``.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Iterable, Mapping, Union

_lock = threading.RLock()
_registry: Dict[str, Any] = {}
_defs: Dict[str, dict] = {}


def _coerce(value: Any, proto: Any) -> Any:
    if isinstance(proto, bool):
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if isinstance(proto, int) and not isinstance(proto, bool):
        return int(value)
    if isinstance(proto, float):
        return float(value)
    return value


def define_flag(name: str, default: Any, doc: str = "") -> None:
    """Register a flag with its default; honours a FLAGS_<name> env
    override."""
    with _lock:
        if name in _defs:
            return
        _defs[name] = {"default": default, "doc": doc}
        env = os.environ.get("FLAGS_" + name)
        _registry[name] = _coerce(env, default) if env is not None else default


def set_flags(flags: Mapping[str, Any]) -> None:
    """``paddle.set_flags``: a ``FLAGS_`` prefix is optional; an unknown
    name raises ``ValueError``."""
    with _lock:
        for name, value in flags.items():
            if name.startswith("FLAGS_"):
                name = name[len("FLAGS_"):]
            if name not in _defs:
                raise ValueError(f"unknown flag: {name}")
            _registry[name] = _coerce(value, _defs[name]["default"])


def get_flags(flags: Union[str, Iterable[str], None] = None
              ) -> Dict[str, Any]:
    """``paddle.get_flags``: every flag, or the named ones (keyed as
    asked, a ``FLAGS_`` prefix optional); an unknown name raises
    ``ValueError``."""
    with _lock:
        if flags is None:
            return dict(_registry)
        if isinstance(flags, str):
            flags = [flags]
        out = {}
        for name in flags:
            key = name[len("FLAGS_"):] if name.startswith("FLAGS_") else name
            if key not in _registry:
                raise ValueError(f"unknown flag: {name}")
            out[name] = _registry[key]
        return out


def flag(name: str) -> Any:
    """Fast internal read of a single flag value."""
    return _registry[name]


define_flag("flash_attention_min_seqlen", 1024,
            "Sequence length at which a GPT attention layer with "
            "use_flash_attention=None switches from the plain softmax(QK)V "
            "composition to the flash kernels.")
define_flag("use_fused_kernels", True,
            "Use the fused kernels (flash attention) when available; "
            "falls back to the plain compositions.")
define_flag("check_nan_inf", False,
            "Check the outputs of every dygraph op for NaN/Inf and raise "
            "FloatingPointError naming the op.")
define_flag("default_dtype", "float32",
            "Default floating dtype for new tensors.")
