"""``paddle.save`` / ``paddle.load`` (the JAX package's ``framework/io.py``;
ref ``python/paddle/framework/io.py:574,791``).

The file is the JAX package's: a zip holding ``MAGIC``, a pickled
skeleton of the object with every tensor replaced by a reference, and the
arrays in one ``arrays.npz``.  A file saved by either package loads in
the other.  Tensors are ``Tensor``s, torch tensors and parameters; they
load as ``Tensor``s (parameters as ``Parameter``s) on the current place.

numpy has no bf16: a bf16 tensor is stored as its ``uint16`` bit view,
with ``"dtype": "bfloat16"`` in its skeleton entry (``utils/convert.py``'s
bit views).  A bf16 array the JAX package wrote (numpy's raw two-byte
``|V2``, which that package cannot read back itself) loads here as bf16.
"""

from __future__ import annotations

import io as _io
import os
import pickle
import zipfile

import numpy as np
import torch

from ..core import device as _device
from ..core.tensor import Tensor, _as_payload, _to_numpy

_MAGIC = "paddle_hackathon_tpu.save.v1"


def _disassemble(obj, arrays):
    if isinstance(obj, (Tensor, torch.Tensor)):
        v = obj._value if isinstance(obj, Tensor) else obj
        key = f"t{len(arrays)}"
        arrays[key] = _to_numpy(v)
        entry = {"__tensor__": key,
                 "__param__": isinstance(obj, torch.nn.Parameter),
                 "name": getattr(obj, "name", None),
                 "stop_gradient": (obj.stop_gradient
                                   if isinstance(obj, Tensor)
                                   else not v.requires_grad)}
        if v.dtype == torch.bfloat16:
            entry["dtype"] = "bfloat16"
        return entry
    if isinstance(obj, dict):
        return {k: _disassemble(v, arrays) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        out = [_disassemble(v, arrays) for v in obj]
        return {"__seq__": type(obj).__name__, "items": out}
    return obj


def _payload(arr, entry) -> torch.Tensor:
    bf16 = entry.get("dtype") == "bfloat16" or arr.dtype.kind == "V"
    if bf16:
        arr = np.ascontiguousarray(arr).view(np.uint16)
    return _as_payload(arr, torch.bfloat16 if bf16 else None,
                       _device.current_device())


def _reassemble(obj, arrays):
    if isinstance(obj, dict):
        if "__tensor__" in obj:
            v = _payload(arrays[obj["__tensor__"]], obj)
            if obj.get("__param__"):
                from ..nn.parameter import Parameter
                p = Parameter(v, name=obj.get("name"))
                p.stop_gradient = obj.get("stop_gradient", False)
                return p
            t = Tensor(v, stop_gradient=obj.get("stop_gradient", True))
            t.name = obj.get("name")
            return t
        if "__seq__" in obj:
            seq = [_reassemble(v, arrays) for v in obj["items"]]
            return tuple(seq) if obj["__seq__"] == "tuple" else seq
        return {k: _reassemble(v, arrays) for k, v in obj.items()}
    return obj


def save(obj, path, protocol=4, **configs):
    """``paddle.save``: state dicts, nested dicts and lists of tensors, and
    plain picklable Python objects."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    arrays = {}
    skeleton = _disassemble(obj, arrays)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        zf.writestr("MAGIC", _MAGIC)
        zf.writestr("skeleton.pkl", pickle.dumps(skeleton, protocol=protocol))
        buf = _io.BytesIO()
        np.savez(buf, **arrays)
        zf.writestr("arrays.npz", buf.getvalue())


def load(path, **configs):
    """``paddle.load``."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with zipfile.ZipFile(path, "r") as zf:
        magic = zf.read("MAGIC").decode()
        if magic != _MAGIC:
            raise ValueError(f"not a paddle_hackathon_tpu checkpoint: {path}")
        skeleton = pickle.loads(zf.read("skeleton.pkl"))
        with zf.open("arrays.npz") as f:
            npz = np.load(_io.BytesIO(f.read()))
            arrays = {k: npz[k] for k in npz.files}
    return _reassemble(skeleton, arrays)
