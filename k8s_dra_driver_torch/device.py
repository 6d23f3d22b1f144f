"""The port's device rule.

Entry points run on the card unless the caller asks for the CPU: the
default device is ``"cuda"``, and without a card that default raises
instead of quietly running on the CPU.  The plain-PyTorch versions of the
kernels are taken only for tensors the caller put on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` (default ``"cuda"``) as a ``torch.device``; raises
    RuntimeError for a CUDA device when no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def params_device(params: dict, device: str | torch.device = "cuda") -> torch.device:
    """:func:`resolve_device`, checked against where ``params`` live (their
    embedding's device): an entry point never moves weights behind the
    caller's back."""
    dev = resolve_device(device)
    where = params["embed"].device
    if where.type != dev.type:
        raise ValueError(f"params live on {where}, not {dev}")
    return dev
