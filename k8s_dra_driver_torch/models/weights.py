"""Load parameters made by the JAX package into the port.

``params_from_jax`` takes the tree that ``burnin.init_params`` (and
``quant.quantize_blocks``) of the JAX package returns — dicts and lists of
arrays, with quantized leaves carrying ``.q``/``.scale`` (int8) or
``.packed``/``.scale``/``.group_size`` (int4) — and returns the port's
params with the same keys and shapes.  Leaves are read through numpy
(``np.asarray``), so nothing of JAX is imported here.
"""

from __future__ import annotations

import numpy as np
import torch

from k8s_dra_driver_torch.device import resolve_device
from k8s_dra_driver_torch.models.burnin import torch_dtype
from k8s_dra_driver_torch.models.quant import Quantized4Matrix, QuantizedMatrix


def tensor_from_array(a, device) -> torch.Tensor:
    """A numpy (or array-like) leaf as a tensor on ``device``, bf16 kept
    bf16 (numpy stores it as the ``bfloat16`` extension dtype)."""
    a = np.array(a)  # a writable, contiguous copy torch may own
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _leaf(x, device):
    if hasattr(x, "packed"):
        return Quantized4Matrix(
            tensor_from_array(x.packed, device), tensor_from_array(x.scale, device),
            int(x.group_size), torch_dtype(x.dtype),
        )
    if hasattr(x, "q") and hasattr(x, "scale"):
        return QuantizedMatrix(
            tensor_from_array(x.q, device), tensor_from_array(x.scale, device),
            torch_dtype(x.dtype),
        )
    return tensor_from_array(x, device)


def params_from_jax(tree, device="cuda"):
    """The JAX package's parameter tree as the port's params on ``device``
    (default the card; raises without one unless ``device="cpu"``)."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return _leaf(node, dev)

    return walk(tree)
