"""Diagonal Gaussian action distribution (port of
``fsrl_tpu/nets/distributions.py:22-50``): closed-form log-prob, entropy and
KL, summed over the last (action) axis."""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


@dataclass
class DiagGaussian:
    mean: torch.Tensor   # (..., A)
    std: torch.Tensor    # (..., A)

    def sample(self, generator: torch.Generator | None = None,
               noise: torch.Tensor | None = None) -> torch.Tensor:
        """``mean + std * eps``; ``noise`` injects ``eps`` (tests)."""
        if noise is None:
            noise = torch.randn(self.mean.shape, generator=generator,
                                device=self.mean.device)
        return self.mean + self.std * noise

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        z = (x - self.mean) / self.std
        per_dim = -0.5 * z * z - torch.log(self.std) - LOG_SQRT_2PI
        return per_dim.sum(-1)

    def entropy(self) -> torch.Tensor:
        return (torch.log(self.std) + 0.5 + LOG_SQRT_2PI).sum(-1)

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self, other: "DiagGaussian") -> torch.Tensor:
        """KL(self || other), summed over the event axis."""
        var, ovar = self.std ** 2, other.std ** 2
        per_dim = (torch.log(other.std) - torch.log(self.std)
                   + (var + (self.mean - other.mean) ** 2) / (2.0 * ovar)
                   - 0.5)
        return per_dim.sum(-1)
