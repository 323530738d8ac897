"""Plain batched versions of the two tasks the configurations train on,
written from their equations (the JAX package's ``envs/car.py``,
``envs/ball.py`` and ``envs/tasks.py``, which the configurations name as
the source):

* ``SafetyCarCircle-v0``: a unicycle (throttle, steering rate);
* ``SafetyBallCircle-v0``: a force-driven point mass with drag.

Circle task: reward for circling counter-clockwise at ``radius``, unit cost
outside ``|x| <= x_lim``; episodes end only by the time limit. A reset
draws its start from the generator the caller passes, in the order the
task's spawn rule states: the angle, then (ball) the radius offset.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.common import uniform

Tensor = torch.Tensor


class Circle:
    """The task's reward, cost and observation extras."""

    def __init__(self, task: dict):
        self.radius, self.x_lim = task["radius"], task["x_lim"]

    def reward_cost(self, pos: Tensor, vel: Tensor):
        x, y = pos[:, 0], pos[:, 1]
        dist = torch.sqrt(x * x + y * y)
        reward = (-y * vel[:, 0] + x * vel[:, 1]) / (
            self.radius * (1.0 + torch.abs(dist - self.radius)))
        cost = (torch.abs(x) > self.x_lim).float()[:, None]
        return reward, cost

    def extras(self, pos: Tensor) -> Tensor:
        r = self.radius
        dist = torch.sqrt(pos[:, 0] * pos[:, 0] + pos[:, 1] * pos[:, 1])
        return torch.stack([pos[:, 0] / r, pos[:, 1] / r, (dist - r) / r,
                            (self.x_lim - torch.abs(pos[:, 0])) / r], 1)

    def spawn(self, pos: Tensor) -> Tensor:
        pos = pos.clone()
        pos[:, 0] = torch.clamp(pos[:, 0], -self.x_lim, self.x_lim)
        return pos


class CarCircle:
    def __init__(self, task: dict):
        self.task, self.horizon = Circle(task), task["max_episode_steps"]
        self.dt, self.accel, self.drag = 0.1, 8.0, 1.0
        self.steer_rate, self.vel_scale = 3.0, 5.0

    def reset(self, n: int, g: torch.Generator) -> dict:
        theta = uniform(n, 0.0, 2 * math.pi, g)
        pos = self.task.radius * torch.stack([torch.cos(theta),
                                              torch.sin(theta)], 1)
        return dict(pos=self.task.spawn(pos), heading=theta + math.pi / 2,
                    speed=torch.zeros_like(theta))

    def step(self, s: dict, a: Tensor) -> dict:
        speed = s["speed"] + self.dt * (self.accel * a[:, 0]
                                        - self.drag * s["speed"])
        heading = s["heading"] + self.dt * self.steer_rate * a[:, 1]
        vel = speed[:, None] * torch.stack([torch.cos(heading),
                                            torch.sin(heading)], 1)
        return dict(pos=s["pos"] + self.dt * vel, heading=heading,
                    speed=speed)

    def vel(self, s: dict) -> Tensor:
        h = s["heading"]
        return s["speed"][:, None] * torch.stack([torch.cos(h),
                                                  torch.sin(h)], 1)

    def obs(self, s: dict) -> Tensor:
        h, v = s["heading"], self.vel(s)
        return torch.cat([v / self.vel_scale, torch.stack(
            [torch.cos(h), torch.sin(h), s["speed"] / self.vel_scale], 1),
            self.task.extras(s["pos"])], 1)


class BallCircle:
    def __init__(self, task: dict):
        self.task, self.horizon = Circle(task), task["max_episode_steps"]
        self.dt, self.accel, self.drag, self.vel_scale = 0.1, 10.0, 1.0, 5.0

    def reset(self, n: int, g: torch.Generator) -> dict:
        theta = uniform(n, 0.0, 2 * math.pi, g)
        r = self.task.radius + uniform(n, -0.5, 0.5, g)
        pos = r[:, None] * torch.stack([torch.cos(theta),
                                        torch.sin(theta)], 1)
        return dict(pos=self.task.spawn(pos), vel=torch.zeros_like(pos))

    def step(self, s: dict, a: Tensor) -> dict:
        vel = s["vel"] + self.dt * (self.accel * a - self.drag * s["vel"])
        return dict(pos=s["pos"] + self.dt * vel, vel=vel)

    def vel(self, s: dict) -> Tensor:
        return s["vel"]

    def obs(self, s: dict) -> Tensor:
        return torch.cat([s["vel"] / self.vel_scale,
                          torch.tanh(s["pos"] / 10.0),
                          self.task.extras(s["pos"])], 1)


ENVS = {"SafetyCarCircle-v0": CarCircle, "SafetyBallCircle-v0": BallCircle}


class VecEnv:
    """N envs with per-env time limits and auto-reset: a fresh start is
    drawn for every env after each step and taken where an episode ended.
    Actions come in [-1, 1] (clipped)."""

    def __init__(self, task: dict, n: int, g: torch.Generator,
                 stagger: bool):
        self.env = ENVS[task["id"]](task)
        self.g = g
        self.sim = self.env.reset(n, g)
        self.obs = self.env.obs(self.sim)
        h = self.env.horizon
        self.t = ((torch.arange(n, device=g.device) * h) // n
                  if stagger and n > 1 else
                  torch.zeros(n, dtype=torch.int64, device=g.device))

    def step(self, act: Tensor):
        """``(obs_next, reward, cost, truncated)`` of the step, before the
        reset."""
        # the policy's [-1, 1] mapped onto the env's bounds, also [-1, 1]
        low, high = -1.0, 1.0
        a = low + (high - low) * (torch.clamp(act, -1.0, 1.0) + 1.0) / 2.0
        a = torch.clamp(a, low, high)
        sim = self.env.step(self.sim, a)
        obs_next = self.env.obs(sim)
        reward, cost = self.env.task.reward_cost(sim["pos"],
                                                 self.env.vel(sim))
        t = self.t + 1
        done = t >= self.env.horizon
        fresh = self.env.reset(a.shape[0], self.g)
        self.sim = {k: torch.where(done.reshape((-1,) + (1,) * (v.dim() - 1)),
                                   fresh[k], v) for k, v in sim.items()}
        self.obs = torch.where(done[:, None], self.env.obs(fresh), obs_next)
        self.t = torch.where(done, torch.zeros_like(t), t)
        return obs_next, reward, cost, done
