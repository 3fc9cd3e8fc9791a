"""Device resolution for the port's entry points.

The JAX package picks its default place from the visible platforms
(``core/device.py``).  The port is written for one CUDA card: every entry
point resolves ``device=None`` to ``cuda`` and raises when there is no
card, so a run that meant the GPU never carries on quietly on the CPU.
The CPU is taken only when the caller names it, as the tests do.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); ``"cpu"`` -> the CPU;
    ``"cuda"``/``"cuda:N"``/a ``torch.device`` -> that device, checked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    if dev.index is not None and dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"{dev} does not exist: "
                           f"{torch.cuda.device_count()} CUDA device(s)")
    return dev
