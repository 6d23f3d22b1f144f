"""Load parameters made by the JAX package into the port.

``params_from_jax`` takes the tree that ``burnin.init_params`` (and
``quant.quantize_blocks``) of the JAX package returns — dicts and lists of
arrays, with quantized leaves carrying ``.q``/``.scale`` (int8) or
``.packed``/``.scale``/``.group_size`` (int4) — and returns the port's
params with the same keys and shapes; ``opt_state_from_jax`` does the same
for the optimizer state.  Leaves are read through numpy (``np.asarray``),
so nothing of JAX is imported here.
"""

from __future__ import annotations

import numpy as np
import torch

from k8s_dra_driver_torch.device import resolve_device
from k8s_dra_driver_torch.models.burnin import param_leaves, torch_dtype
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


def params_to_numpy(params):
    """The inverse of :func:`params_from_jax` for float params: the port's
    params tree (dicts and lists of tensors) as numpy arrays on the host,
    bf16 kept bf16 (numpy's ``bfloat16`` extension dtype, which JAX's
    arrays use too).  Reading the arrays waits for the device."""

    def leaf(t):
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"params_to_numpy takes tensors, got {type(t).__name__}")
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes

            return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return leaf(node)

    return walk(params)


def _adam_state(node):
    """The first node of an optax state tree with ``count``, ``mu`` and
    ``nu`` (its ``ScaleByAdamState``), or None."""
    if all(hasattr(node, f) for f in ("count", "mu", "nu")):
        return node
    if isinstance(node, (tuple, list)):
        for child in node:
            found = _adam_state(child)
            if found is not None:
                return found
    return None


def opt_state_from_jax(state, device="cuda") -> dict:
    """The JAX package's optimizer state (optax's ``adamw`` from
    ``make_optimizer``: its ``ScaleByAdamState``, alone in the ``chain`` or
    after ``clip_by_global_norm``) as the port's ``AdamW`` state on
    ``device``: ``count`` an int32 0-d tensor, ``mu`` and ``nu`` lists in the
    order of the params' leaves.  The schedule's own count in optax's state
    always equals Adam's, so the one count carries both."""
    adam = _adam_state(state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the optimizer state")
    dev = resolve_device(device)
    return {
        "count": tensor_from_array(np.asarray(adam.count, dtype=np.int32), dev),
        "mu": param_leaves(params_from_jax(adam.mu, dev)),
        "nu": param_leaves(params_from_jax(adam.nu, dev)),
    }
