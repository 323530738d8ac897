"""Device selection for the port: CUDA unless the caller asks for the CPU.

The port's entry points run on the card. A machine without CUDA is an error,
not a reason to fall back: a silent CPU run would report CPU numbers under the
name of the GPU path. Tests pass ``device="cpu"`` explicitly.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``. Raises if a CUDA device is asked for and the
    machine has none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fsrl_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
