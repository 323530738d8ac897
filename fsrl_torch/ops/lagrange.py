"""PID Lagrangian multiplier (port of ``fsrl_tpu/ops/lagrange.py``),
vectorized over M constraints:

    e      = cost - limit
    d      = max(0, e - e_old)
    I      = max(0, I + e)
    lambda = max(0, Kp*e + Ki*I + Kd*d)

``filtered_pid_step`` is the JAX package's hardened controller: an
episode-count-weighted EMA of the measurement and a symmetric, clipped
integral. Both controllers hold all state on collects that finished no
episode. Every step is tensor code with ``torch.where``: no host sync.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch


@dataclass
class PIDLagrangianState:
    error_old: torch.Tensor       # (M,)
    error_integral: torch.Tensor  # (M,)
    multiplier: torch.Tensor      # (M,)
    cost_ema: torch.Tensor        # (M,) filtered mean episodic cost
    ema_n: torch.Tensor           # () effective sample count

    @classmethod
    def init(cls, n_constraints: int = 1,
             device: torch.device | str = "cpu") -> "PIDLagrangianState":
        z = lambda: torch.zeros(n_constraints, device=device)
        return cls(error_old=z(), error_integral=z(), multiplier=z(),
                   cost_ema=z(), ema_n=torch.zeros((), device=device))


def _hold(n_episodes, new: PIDLagrangianState,
          old: PIDLagrangianState) -> PIDLagrangianState:
    step = n_episodes > 0
    return PIDLagrangianState(**{
        f.name: torch.where(step, getattr(new, f.name), getattr(old, f.name))
        for f in fields(old)})


def pid_step(state: PIDLagrangianState, cost_values, cost_limits,
             kp: float, ki: float, kd: float) -> PIDLagrangianState:
    """The exact reference recurrence."""
    error_new = cost_values - cost_limits
    error_diff = torch.relu(error_new - state.error_old)
    error_integral = torch.relu(state.error_integral + error_new)
    multiplier = torch.relu(kp * error_new + ki * error_integral
                            + kd * error_diff)
    return PIDLagrangianState(error_old=error_new,
                              error_integral=error_integral,
                              multiplier=multiplier, cost_ema=state.cost_ema,
                              ema_n=state.ema_n)


def filtered_pid_step(state: PIDLagrangianState, cost_values, n_episodes,
                      cost_limits, kp: float, ki: float, kd: float, *,
                      horizon: float = 10.0) -> PIDLagrangianState:
    """EMA-filtered, anti-windup PID step; holds state on episode-free
    collects."""
    n_ep = n_episodes.float()
    w = n_ep / torch.clamp(state.ema_n + n_ep, min=1e-8)
    cost_f = state.cost_ema + w * (cost_values - state.cost_ema)
    ema_n = torch.clamp(state.ema_n + n_ep, max=horizon)
    error_new = cost_f - cost_limits
    error_diff = torch.relu(error_new - state.error_old)
    cap = torch.clamp(cost_limits, min=1.0)
    e_int = torch.minimum(torch.maximum(error_new, -cap), cap)
    error_integral = torch.relu(state.error_integral + e_int)
    multiplier = torch.relu(kp * error_new + ki * error_integral
                            + kd * error_diff)
    stepped = PIDLagrangianState(error_old=error_new,
                                 error_integral=error_integral,
                                 multiplier=multiplier, cost_ema=cost_f,
                                 ema_n=ema_n)
    return _hold(n_episodes, stepped, state)


def pid_controller_step(state: PIDLagrangianState, cost_values, n_episodes,
                        cost_limits, kp: float, ki: float, kd: float, *,
                        filtered: bool = True,
                        horizon: float = 10.0) -> PIDLagrangianState:
    """The hardened ``filtered_pid_step`` (default) or the exact reference
    recurrence, which tracks the raw measurement in ``cost_ema``."""
    if filtered:
        return filtered_pid_step(state, cost_values, n_episodes, cost_limits,
                                 kp, ki, kd, horizon=horizon)
    stepped = pid_step(state, cost_values, cost_limits, kp, ki, kd)
    stepped.cost_ema = cost_values
    return _hold(n_episodes, stepped, state)


def rescaling_factor(multiplier: torch.Tensor,
                     rescaling: bool = True) -> torch.Tensor:
    """Stooke et al.'s multiplier rescaling ``1 / (sum(lambda) + 1)``."""
    if not rescaling:
        return torch.ones((), device=multiplier.device)
    return 1.0 / (multiplier.sum() + 1.0)
