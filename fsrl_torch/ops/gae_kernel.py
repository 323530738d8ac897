"""Kernel K1: GAE as one fused CUDA pass (``csrc/gae.cu``).

Replaces ``fsrl_tpu/ops/pallas_gae.py::gae_advantages_pallas``. On a CUDA
tensor the wrapper launches the kernel (or raises); on a CPU tensor it runs
the plain version, ``fsrl_torch.ops.gae.gae_advantages``. The kernel reads
m, v, v' and the end flags once each and writes adv and ret once; nothing is
padded. A block owns a strip of ``STRIP`` columns of the time-major
``(T, N*K)`` view and walks time in tiles of ``TIME_TILE`` steps from the
end: all its threads load a tile, one thread per column runs the recurrence
out of shared memory, all threads write back. The result equals the plain
loop's bit for bit.
"""

from __future__ import annotations

import torch

from fsrl_torch.ops import kernels
from fsrl_torch.ops.gae import gae_advantages

STRIP = 32        # columns per block (CW in gae.cu)
TIME_TILE = 64    # time steps per shared-memory tile (TT in gae.cu)


def gae_advantages_fused(metrics: torch.Tensor, values: torch.Tensor,
                         values_next: torch.Tensor, end_flag: torch.Tensor,
                         gamma: float, lam: float):
    """Same contract as :func:`gae_advantages`: (T, N, K) float32 inputs,
    (T, N) bool flags → ``(adv, ret)``."""
    if metrics.device.type == "cpu":
        return gae_advantages(metrics, values, values_next, end_flag,
                              gamma, lam)
    T, N, K = metrics.shape
    req = kernels.require
    for name, x in (("metrics", metrics), ("values", values),
                    ("values_next", values_next)):
        req(x.is_cuda and x.dtype == torch.float32 and x.is_contiguous()
            and x.shape == (T, N, K),
            f"gae kernel: {name} must be a contiguous float32 CUDA tensor "
            f"of shape {(T, N, K)}, got {x.dtype} {tuple(x.shape)}")
    req(end_flag.is_cuda and end_flag.dtype == torch.bool
        and end_flag.is_contiguous() and end_flag.shape == (T, N),
        "gae kernel: end_flag must be a contiguous (T, N) bool CUDA tensor")
    req(len({x.device for x in (metrics, values, values_next, end_flag)})
        == 1, "gae kernel: all inputs must be on one device")
    adv = torch.empty_like(metrics)
    ret = torch.empty_like(metrics)
    lib = kernels.library()
    with torch.cuda.device(metrics.device):
        rc = lib.fsrl_gae(metrics.data_ptr(), values.data_ptr(),
                          values_next.data_ptr(), end_flag.data_ptr(),
                          adv.data_ptr(), ret.data_ptr(), T, N, K,
                          float(gamma), float(gamma * lam),
                          kernels.stream_ptr())
    kernels.check(rc, "gae kernel")
    kernels.LAUNCHES["gae"] += 1
    return adv, ret
