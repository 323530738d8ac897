"""fsrl_torch: the PyTorch / CUDA (H100) port of fsrl_tpu.

Module names follow ``fsrl_tpu`` so each port module sits at the same path as
its JAX counterpart. The port imports ``torch`` only; it never imports JAX or
the JAX package. Entry points run on CUDA unless ``device="cpu"`` is given.
"""

from fsrl_torch.device import resolve_device

__all__ = ["resolve_device"]
__version__ = "0.1.0"
