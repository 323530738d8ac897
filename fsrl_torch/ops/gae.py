"""GAE over joint (reward, cost, ...) value channels (port of
``fsrl_tpu/ops/gae.py::gae_advantages`` and ``discounted_returns``). The
plain version of kernel K1:

    delta_t = m_t + gamma * v'_t - v_t          (v' already value-masked)
    adv_t   = delta_t + (1 - end_t) * gamma * lam * adv_{t+1}

as a reverse loop over time, all K channels at once.
"""

from __future__ import annotations

import torch


def gae_advantages(metrics: torch.Tensor, values: torch.Tensor,
                   values_next: torch.Tensor, end_flag: torch.Tensor,
                   gamma: float, lam: float):
    """``metrics``, ``values``, ``values_next``: (T, N, K); ``end_flag``:
    (T, N) bool. Returns ``(adv, ret)`` of shape (T, N, K), ret = adv + v."""
    delta = metrics + gamma * values_next - values
    disc = (1.0 - end_flag.to(delta.dtype))[..., None] * (gamma * lam)
    adv = torch.empty_like(delta)
    gae = torch.zeros_like(delta[0])
    for t in range(delta.shape[0] - 1, -1, -1):
        gae = delta[t] + disc[t] * gae
        adv[t] = gae
    return adv, adv + values


def discounted_returns(metrics: torch.Tensor, end_flag: torch.Tensor,
                       bootstrap: torch.Tensor, gamma: float) -> torch.Tensor:
    """Discounted return-to-go (GAE's lam = 1 shortcut): ``metrics`` (T, N,
    K), ``end_flag`` (T, N), ``bootstrap`` (N, K) the masked value after the
    last step. Returns (T, N, K)."""
    cont = (1.0 - end_flag.to(metrics.dtype))[..., None]
    out = torch.empty_like(metrics)
    ret = bootstrap
    for t in range(metrics.shape[0] - 1, -1, -1):
        ret = metrics[t] + gamma * cont[t] * ret
        out[t] = ret
    return out
