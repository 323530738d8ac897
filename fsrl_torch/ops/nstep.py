"""n-step Bellman targets for the ring replay buffer (port of
``fsrl_tpu/ops/nstep.py``).

From sampled flat indices into the ``(C, N)`` ring, follow each env's
successor chain up to ``n_step`` rows (stalling at episode ends), then

    G = sum_{k<K} gamma^k m_{t+k} + gamma^K * maskedQ(s_{t+K})

where K <= n_step shrinks at episode boundaries as the reference's
``gammas`` bookkeeping does. Both functions are ``n_step`` gathers over the
whole batch; nothing loops over the batch on the host.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def nstep_forward_indices(idx: Tensor, next_flat: Tensor,
                          n_step: int) -> Tensor:
    """``(n_step, B)`` chain: ``chain[0] = idx``, ``chain[k]`` its k-th
    successor through ``next_flat`` (the buffer's ``next_flat``)."""
    chain = [idx]
    for _ in range(n_step - 1):
        chain.append(next_flat[chain[-1]])
    return torch.stack(chain)


def nstep_targets(metrics: Tensor, end_flag: Tensor, target_q: Tensor,
                  indices: Tensor, gamma: float) -> Tensor:
    """The reference recurrence, walking n from last to first:

        returns[end@now] = 0 ;  gammas[end@now] = n + 1
        returns = m[now] + gamma * returns

    then ``target = gamma^gammas * Q_terminal + returns``, shape ``(B, K)``.
    ``metrics`` is ``(C*N, K)``, ``end_flag`` ``(C*N,)``, ``target_q``
    ``(B, K)`` (already masked), ``indices`` the chain."""
    n_step, B = indices.shape
    returns = torch.zeros(B, metrics.shape[-1], dtype=metrics.dtype,
                          device=metrics.device)
    gammas = torch.full((B,), n_step, dtype=torch.int32,
                        device=metrics.device)
    for n in range(n_step - 1, -1, -1):
        now = indices[n]
        ended = end_flag[now]
        gammas = torch.where(ended, n + 1, gammas)
        returns = torch.where(ended[:, None], 0.0, returns)
        returns = metrics[now] + gamma * returns
    discount = torch.pow(gamma, gammas.to(metrics.dtype))
    return target_q * discount[:, None] + returns
