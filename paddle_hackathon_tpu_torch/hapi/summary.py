"""Model summary and FLOPs (the JAX package's ``hapi/summary.py``; ref
``python/paddle/hapi/model_summary.py``, ``dynamic_flops.py``)."""

from __future__ import annotations

import numpy as np


def summary(net, input_size=None, dtypes=None, input=None):  # noqa: A002
    """Print a per-layer parameter table; returns totals dict."""
    rows = []
    total = 0
    trainable = 0
    for name, p in net.named_parameters():
        n = int(p.numel())
        total += n
        if getattr(p, "trainable", p.requires_grad):
            trainable += n
        rows.append((name, tuple(p.shape), n))
    width = max([len(r[0]) for r in rows], default=20) + 2
    print(f"{'Layer (param)':<{width}}{'Shape':<24}{'Param #':>12}")
    print("-" * (width + 36))
    for name, shape, n in rows:
        print(f"{name:<{width}}{str(shape):<24}{n:>12,}")
    print("-" * (width + 36))
    print(f"Total params: {total:,}")
    print(f"Trainable params: {trainable:,}")
    print(f"Non-trainable params: {total - trainable:,}")
    return {"total_params": total, "trainable_params": trainable}


def flops(net, input_size=None, inputs=None, custom_ops=None,
          print_detail=False):
    """Estimate forward FLOPs by layer (ref ``python/paddle/hapi/dynamic_flops.py``).

    Runs one forward pass with forward hooks on the leaf layers; counts
    matmul/conv multiply-adds (elementwise ops are ignored, as in the
    reference's per-layer-type count tables).
    """
    counts = {}
    handles = []
    custom_ops = custom_ops or {}

    def _count(layer, inp, out):
        cls = type(layer).__name__
        x = inp[0] if isinstance(inp, (tuple, list)) else inp
        o = out[0] if isinstance(out, (tuple, list)) else out
        n = 0
        if cls in custom_ops:
            n = int(custom_ops[cls](layer, inp, out))
        elif hasattr(layer, "weight") and layer.weight is not None:
            w = layer.weight
            if cls.startswith("Conv"):
                # output elements x per-element kernel MACs
                kernel = int(np.prod(w.shape[1:]))
                n = 2 * int(np.prod(o.shape)) * kernel
            elif cls == "Linear":
                n = 2 * int(np.prod(x.shape[:-1])) * int(w.shape[0]) * int(w.shape[1])
            elif cls == "Embedding":
                n = 0
        counts[id(layer)] = counts.get(id(layer), 0) + n

    for sub in net.sublayers(include_self=True):
        if not list(sub.children()):  # leaf layers only
            handles.append(sub.register_forward_hook(_count))

    if inputs is None:
        if input_size is None:
            raise ValueError("flops() needs input_size or inputs")
        from ..core.tensor import to_tensor
        inputs = to_tensor(np.zeros(input_size, np.float32))
    was_training = getattr(net, "training", False)
    try:
        net.eval()
        net(inputs)
    finally:
        if was_training:
            net.train()
        for h in handles:
            h.remove()
    total = sum(counts.values())
    if print_detail:
        print(f"Total FLOPs: {total:,}")
    return total
