"""Device selection for the PyTorch port.

Every entry point takes ``device=`` and defaults to ``"cuda"``. Asking for
CUDA on a machine without a usable GPU raises; nothing silently carries on
on the CPU. Tests pass ``device="cpu"`` explicitly.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``"cuda"`` (the default), ``"cuda:N"``, ``"cpu"`` or a ``torch.device``
    → ``torch.device``. Raises ``RuntimeError`` if CUDA is asked for and
    ``torch.cuda.is_available()`` is false."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is available "
            "(torch.cuda.is_available() is False); pass device='cpu' to run "
            "on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}: use 'cuda' or 'cpu'")
    return dev
