"""What the plain references share: Adam on a dict of leaves, the filtered
PID multiplier, ReLU towers and the diagonal Gaussian's log-density.

Plain PyTorch, float32, written from the algorithms' published equations
(and the JAX package's choices where the papers leave one open, such as the
PID filter). Nothing here imports the program under test.
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor
LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def set_tf32(on: bool) -> None:
    """TF32 products off for the reference; on only for the control."""
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def uniform(shape, low: float, high: float, g: torch.Generator) -> Tensor:
    return low + (high - low) * torch.rand(shape, generator=g,
                                           device=g.device)


class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8) over a dict of leaves with one step
    count, optionally after clipping the gradient's global norm."""

    def __init__(self, lr: float, max_grad_norm: float | None = None):
        self.lr, self.max_grad_norm = lr, max_grad_norm

    def init(self, params: dict[str, Tensor]) -> dict:
        return dict(count=0, mu={k: torch.zeros_like(v)
                                 for k, v in params.items()},
                    nu={k: torch.zeros_like(v) for k, v in params.items()})

    def step(self, params: dict[str, Tensor], grads: dict[str, Tensor],
             state: dict) -> tuple[dict, dict]:
        """New leaves and optimizer state (the inputs are left alone)."""
        b1, b2 = 0.9, 0.999
        if self.max_grad_norm is not None:
            norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
            clip = norm >= self.max_grad_norm
            grads = {k: torch.where(clip, g / norm * self.max_grad_norm, g)
                     for k, g in grads.items()}
        count = state["count"] + 1
        mu = {k: (1 - b1) * g + b1 * state["mu"][k] for k, g in grads.items()}
        nu = {k: (1 - b2) * (g * g) + b2 * state["nu"][k]
              for k, g in grads.items()}
        c1, c2 = 1 - b1 ** count, 1 - b2 ** count
        new = {k: params[k] - self.lr * ((mu[k] / c1)
                                         / (torch.sqrt(nu[k] / c2) + 1e-8))
               for k in params}
        return new, dict(count=count, mu=mu, nu=nu)


class FilteredPID:
    """The PID Lagrangian multiplier on an episode-weighted moving average of
    the collects' mean episodic cost, with a clipped integral; it holds its
    state on a collect that finished no episode."""

    def __init__(self, n: int, limit: float, pid, horizon: float,
                 device):
        self.kp, self.ki, self.kd = pid
        self.limit = torch.full((n,), float(limit), device=device)
        self.horizon = horizon
        z = lambda: torch.zeros(n, device=device)
        self.e_old, self.integral, self.multiplier, self.ema = z(), z(), z(), z()
        self.ema_n = torch.zeros((), device=device)

    def step(self, mean_cost: Tensor, n_episodes: Tensor) -> Tensor:
        n = n_episodes.float()
        w = n / torch.clamp(self.ema_n + n, min=1e-8)
        ema = self.ema + w * (mean_cost - self.ema)
        ema_n = torch.clamp(self.ema_n + n, max=self.horizon)
        e = ema - self.limit
        d = torch.relu(e - self.e_old)
        cap = torch.clamp(self.limit, min=1.0)
        integral = torch.relu(self.integral + torch.clamp(e, -cap, cap))
        mult = torch.relu(self.kp * e + self.ki * integral + self.kd * d)
        keep = n_episodes > 0
        self.e_old = torch.where(keep, e, self.e_old)
        self.integral = torch.where(keep, integral, self.integral)
        self.multiplier = torch.where(keep, mult, self.multiplier)
        self.ema = torch.where(keep, ema, self.ema)
        self.ema_n = torch.where(keep, ema_n, self.ema_n)
        return self.multiplier


def tower(x: Tensor, ws: list[Tensor], bs: list[Tensor]) -> Tensor:
    """ReLU layers ``x W^T + b`` with a linear last layer."""
    for i, (w, b) in enumerate(zip(ws, bs)):
        x = x @ w.T + b
        if i < len(ws) - 1:
            x = torch.relu(x)
    return x


def gaussian_logp(x: Tensor, mean: Tensor, std: Tensor) -> Tensor:
    z = (x - mean) / std
    return (-0.5 * z * z - torch.log(std) - LOG_SQRT_2PI).sum(-1)


class Episodes:
    """Per-env running episode sums, and the collect's finished-episode
    count and cost sum."""

    def __init__(self, n: int, m: int, device):
        self.ep_cost = torch.zeros(n, m, device=device)
        self.reset_collect()

    def reset_collect(self) -> None:
        dev = self.ep_cost.device
        self.n_episodes = torch.zeros((), dtype=torch.int64, device=dev)
        self.sum_cost = torch.zeros(self.ep_cost.shape[1], device=dev)

    def add(self, cost: Tensor, done: Tensor) -> None:
        ep = self.ep_cost + cost
        self.n_episodes = self.n_episodes + done.sum()
        self.sum_cost = self.sum_cost + (done[:, None].float() * ep).sum(0)
        self.ep_cost = torch.where(done[:, None], torch.zeros_like(ep), ep)

    def mean_cost(self) -> Tensor:
        return self.sum_cost / torch.clamp(self.n_episodes, min=1)
