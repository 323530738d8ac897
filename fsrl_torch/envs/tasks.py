"""Run / Circle task definitions on batched states (port of
``fsrl_tpu/envs/tasks.py``; same formulas, same operation order).

* **Run**: reward for forward velocity along +x; unit cost outside the
  corridor ``|y| <= y_lim`` or above ``speed_limit``.
* **Circle**: reward for circulating counter-clockwise on a circle of radius
  ``radius``; cost outside the band ``|x| <= x_lim``.

``pos`` and ``vel`` are ``(N, 2)``; rewards are ``(N,)``, costs ``(N, M)``
and observation extras ``(N, E)``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1])


@dataclass(frozen=True)
class RunTask:
    y_lim: float = 2.0
    speed_limit: float = 6.0
    v_target: float = 4.0
    num_costs: int = 1
    n_extras: int = 3

    def reward_cost(self, pos, vel):
        reward = vel[:, 0] / self.v_target
        speed = _norm(vel)
        cost = torch.logical_or(torch.abs(pos[:, 1]) > self.y_lim,
                                speed > self.speed_limit).float()
        return reward, cost[:, None]

    def obs_extras(self, pos, vel):
        speed = _norm(vel)
        return torch.stack([
            pos[:, 1] / self.y_lim,
            (self.y_lim - torch.abs(pos[:, 1])) / self.y_lim,
            (self.speed_limit - speed) / self.speed_limit,
        ], dim=1)


@dataclass(frozen=True)
class CircleTask:
    radius: float = 7.0
    x_lim: float = 4.0
    num_costs: int = 1
    n_extras: int = 4

    def _reward(self, pos, vel):
        x, y = pos[:, 0], pos[:, 1]
        dist = torch.sqrt(x * x + y * y)
        return (-y * vel[:, 0] + x * vel[:, 1]) / (
            self.radius * (1.0 + torch.abs(dist - self.radius)))

    def reward_cost(self, pos, vel):
        cost = (torch.abs(pos[:, 0]) > self.x_lim).float()
        return self._reward(pos, vel), cost[:, None]

    def obs_extras(self, pos, vel):
        dist = _norm(pos)
        return torch.stack([
            pos[:, 0] / self.radius,
            pos[:, 1] / self.radius,
            (dist - self.radius) / self.radius,
            (self.x_lim - torch.abs(pos[:, 0])) / self.radius,
        ], dim=1)


@dataclass(frozen=True)
class CircleBoundSpeedTask(CircleTask):
    """Two-constraint Circle: cost channel 0 is the position band, channel 1
    the speed limit."""

    speed_limit: float = 6.0
    num_costs: int = 2
    n_extras: int = 5

    def reward_cost(self, pos, vel):
        cost_pos = (torch.abs(pos[:, 0]) > self.x_lim).float()
        cost_speed = (_norm(vel) > self.speed_limit).float()
        return self._reward(pos, vel), torch.stack([cost_pos, cost_speed], 1)

    def obs_extras(self, pos, vel):
        speed = _norm(vel)
        return torch.cat([
            super().obs_extras(pos, vel),
            ((self.speed_limit - speed) / self.speed_limit)[:, None]], dim=1)
