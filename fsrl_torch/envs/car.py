"""Car agent: planar unicycle (throttle + steering rate), batched
(port of ``fsrl_tpu/envs/car.py``): SafetyCarRun-v0 / SafetyCarCircle-v0."""

from __future__ import annotations

import math

import torch

from fsrl_torch.envs.base import SafeEnv, register, scale
from fsrl_torch.envs.tasks import CircleTask, RunTask

DT = 0.1
ACCEL = 8.0
DRAG = 1.0          # terminal speed 8
STEER_RATE = 3.0
VEL_SCALE = 5.0


class CarEnv(SafeEnv):
    action_size = 2  # (throttle, steer)
    max_episode_steps = 500

    def __init__(self, task):
        self.task = task
        self.num_costs = task.num_costs
        self.observation_size = 5 + task.n_extras

    def _reset_draw_shapes(self, n):
        if isinstance(self.task, CircleTask):
            return [(n,)]
        return [(n, 2), (n,)]

    def _init_sim_from(self, u):
        if isinstance(self.task, CircleTask):
            theta = scale(u[0], 0.0, 2 * math.pi)
            pos = self.task.radius * torch.stack(
                [torch.cos(theta), torch.sin(theta)], 1)
            pos[:, 0] = torch.clamp(pos[:, 0], -self.task.x_lim,
                                    self.task.x_lim)
            heading = theta + math.pi / 2  # tangential
        else:
            pos = scale(u[0], -0.5, 0.5)
            heading = scale(u[1], -0.3, 0.3)
        return dict(pos=pos, heading=heading, speed=torch.zeros_like(heading))

    def _step_sim(self, sim, action):
        throttle, steer = action[:, 0], action[:, 1]
        speed = sim["speed"] + DT * (ACCEL * throttle - DRAG * sim["speed"])
        heading = sim["heading"] + DT * STEER_RATE * steer
        vel = speed[:, None] * torch.stack(
            [torch.cos(heading), torch.sin(heading)], 1)
        pos = sim["pos"] + DT * vel
        return dict(pos=pos, heading=heading, speed=speed)

    def _vel(self, sim):
        h = sim["heading"]
        return sim["speed"][:, None] * torch.stack(
            [torch.cos(h), torch.sin(h)], 1)

    def _obs(self, sim):
        vel = self._vel(sim)
        h = sim["heading"]
        base = torch.cat([
            vel / VEL_SCALE,
            torch.stack([torch.cos(h), torch.sin(h),
                         sim["speed"] / VEL_SCALE], 1)], 1)
        return torch.cat([base, self.task.obs_extras(sim["pos"], vel)], 1)

    def _reward_cost(self, sim_prev, sim, action):
        return self.task.reward_cost(sim["pos"], self._vel(sim))


register("SafetyCarRun-v0", lambda **kw: CarEnv(RunTask(**kw)))
register("SafetyCarCircle-v0", lambda **kw: CarEnv(CircleTask(**kw)))
