"""Action distributions (port of ``fsrl_tpu/nets/distributions.py``): the
diagonal Gaussian with closed-form log-prob, entropy and KL, summed over the
last (action) axis; CVPO's decoupled KL; SAC's tanh-squashed Gaussian."""

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


def gaussian_kl_decoupled(mean_old, std_old, mean_new, std_new):
    """CVPO's decoupled KL (``fsrl_tpu/nets/distributions.py:53-64``): a
    mean term under the old std and a covariance term in which the old mean
    plays no part, each summed over the event axis."""
    var_old, var_new = std_old ** 2, std_new ** 2
    kl_mean = (0.5 * (mean_new - mean_old) ** 2 / var_old).sum(-1)
    kl_std = (torch.log(std_new) - torch.log(std_old)
              + var_old / (2.0 * var_new) - 0.5).sum(-1)
    return kl_mean, kl_std


@dataclass
class TanhGaussian:
    """tanh-squashed Gaussian (``fsrl_tpu/nets/distributions.py:67-93``):
    ``logp`` is the base log-prob minus ``sum log(1 - tanh(x)^2)``, written
    stably as ``2 (log 2 - x - softplus(-2x))``."""

    mean: torch.Tensor
    std: torch.Tensor

    def sample_and_log_prob(self, generator: torch.Generator | None = None,
                            noise: torch.Tensor | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
        """``(tanh(x), logp)`` for ``x = mean + std * eps``; ``noise``
        injects ``eps`` (tests)."""
        base = DiagGaussian(self.mean, self.std)
        x = base.sample(generator, noise)
        return torch.tanh(x), base.log_prob(x) - _tanh_correction(x)

    def mode(self) -> torch.Tensor:
        return torch.tanh(self.mean)

    def log_prob_from_pre_tanh(self, x: torch.Tensor) -> torch.Tensor:
        return DiagGaussian(self.mean, self.std).log_prob(x) \
            - _tanh_correction(x)


def _tanh_correction(x: torch.Tensor) -> torch.Tensor:
    # softplus as logaddexp(., 0), exact like JAX's: F.softplus switches to
    # the identity above its threshold
    softplus = torch.logaddexp(-2.0 * x, torch.zeros((), device=x.device))
    return (2.0 * (math.log(2.0) - x - softplus)).sum(-1)
