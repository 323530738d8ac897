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

    def update(self, batch: torch.Tensor) -> "RunningMeanStd":
        """Merge a batch whose leading axis is samples."""
        b_mean = batch.mean(0)
        b_var = batch.var(0, unbiased=False)
        b_count = torch.tensor(float(batch.shape[0]), device=batch.device)
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
