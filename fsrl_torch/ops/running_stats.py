"""Welford running mean / variance (port of
``fsrl_tpu/ops/running_stats.py``), Chan's parallel merge of a batch, and
normalizing by the statistics."""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class RunningMeanStd:
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor

    @classmethod
    def init(cls, shape=(), device: torch.device | str = "cpu"
             ) -> "RunningMeanStd":
        return cls(mean=torch.zeros(shape, device=device),
                   var=torch.ones(shape, device=device),
                   count=torch.tensor(1e-4, device=device))

    def update(self, batch: torch.Tensor, dp=None) -> "RunningMeanStd":
        """Merge a batch whose leading axis is samples. With ``dp`` (a
        :class:`fsrl_torch.parallel.mesh.DPGroup`) the batch is the rank's
        part of a global batch (equal parts), whose mean and variance come
        from the ranks' by Chan's merge (two ``all_reduce``)."""
        if dp is None:
            b_mean = batch.mean(0)
            b_var = batch.var(0, unbiased=False)
            n = batch.shape[0]
        else:
            n = batch.shape[0] * dp.size
            r_mean = batch.mean(0)
            (b_mean,) = dp.weighted_sum(1.0 / dp.size, r_mean)
            m2 = (batch.var(0, unbiased=False) * batch.shape[0]
                  + batch.shape[0] * (r_mean - b_mean) ** 2)
            (b_var,) = dp.weighted_sum(1.0 / n, m2)
        b_count = torch.full((), float(n), device=batch.device)
        delta = b_mean - self.mean
        tot = self.count + b_count
        new_mean = self.mean + delta * b_count / tot
        m2 = (self.var * self.count + b_var * b_count
              + delta ** 2 * self.count * b_count / tot)
        return RunningMeanStd(mean=new_mean, var=m2 / tot, count=tot)

    def normalize(self, x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
        return (x - self.mean) / torch.sqrt(self.var + eps)

    def scale(self, x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
        return x / torch.sqrt(self.var + eps)

    def unscale(self, x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
        return x * torch.sqrt(self.var + eps)
