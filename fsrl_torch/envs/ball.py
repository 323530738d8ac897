"""Ball agent: 2-D force-controlled point mass with drag, batched (port of
``fsrl_tpu/envs/ball.py``): SafetyBallRun-v0 / SafetyBallCircle-v0 and the
two-constraint SafetyBallCircle2C-v0."""

from __future__ import annotations

import math

import torch

from fsrl_torch.envs.base import SafeEnv, register, scale
from fsrl_torch.envs.tasks import CircleBoundSpeedTask, CircleTask, RunTask

DT = 0.1
ACCEL = 10.0
DRAG = 1.0          # terminal speed = ACCEL/DRAG = 10 per axis
VEL_SCALE = 5.0     # obs normalization


class BallEnv(SafeEnv):
    action_size = 2
    max_episode_steps = 500

    def __init__(self, task):
        self.task = task
        self.num_costs = task.num_costs
        self.observation_size = 4 + task.n_extras

    def _reset_draw_shapes(self, n):
        if isinstance(self.task, CircleTask):
            return [(n,), (n,)]
        return [(n, 2), (n, 2)]

    def _init_sim_from(self, u):
        if isinstance(self.task, CircleTask):
            # spawn near the circle with small noise, inside the safe band
            theta = scale(u[0], 0.0, 2 * math.pi)
            r = self.task.radius + scale(u[1], -0.5, 0.5)
            pos = r[:, None] * torch.stack(
                [torch.cos(theta), torch.sin(theta)], 1)
            pos[:, 0] = torch.clamp(pos[:, 0], -self.task.x_lim,
                                    self.task.x_lim)
            vel = torch.zeros_like(pos)
        else:
            pos = scale(u[0], -0.5, 0.5)
            vel = scale(u[1], -0.1, 0.1)
        return dict(pos=pos, vel=vel)

    def _step_sim(self, sim, action):
        acc = ACCEL * action - DRAG * sim["vel"]
        vel = sim["vel"] + DT * acc
        pos = sim["pos"] + DT * vel
        return dict(pos=pos, vel=vel)

    def _obs(self, sim):
        base = torch.cat([sim["vel"] / VEL_SCALE,
                          torch.tanh(sim["pos"] / 10.0)], 1)
        return torch.cat(
            [base, self.task.obs_extras(sim["pos"], sim["vel"])], 1)

    def _reward_cost(self, sim_prev, sim, action):
        return self.task.reward_cost(sim["pos"], sim["vel"])


register("SafetyBallRun-v0", lambda **kw: BallEnv(RunTask(**kw)))
register("SafetyBallCircle-v0", lambda **kw: BallEnv(CircleTask(**kw)))
register("SafetyBallCircle2C-v0",
         lambda **kw: BallEnv(CircleBoundSpeedTask(**kw)))
