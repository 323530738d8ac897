"""Ant agent: planar quadruped with a paddling-gait contact model, batched
(port of ``fsrl_tpu/envs/ant.py``): SafetyAntRun-v0 / SafetyAntCircle-v0.

Torso (2-D position, heading, body-frame velocity) plus four legs, each
with a stroke angle ``alpha`` (hip sweep) and a lift in [0, 1] (knee).
Actions are (stroke rate, lift) x 4. A grounded leg sweeping backward
thrusts forward and one sweeping forward brakes, so progress needs the
swing-lift / power-press cycle; left / right thrust asymmetry turns the
torso. A fall (every leg lifted at speed) terminates the episode and
charges the cost channel ``FALL_COST`` on that step.
"""

from __future__ import annotations

import math

import torch

from fsrl_torch.envs.base import SafeEnv, register, uniform
from fsrl_torch.envs.tasks import CircleTask, RunTask

DT = 0.05
STROKE_RATE = 6.0      # max hip sweep speed (rad/s)
STROKE_LIM = 0.8       # hip sweep range (rad)
THRUST = 2.5           # per-leg thrust coefficient
DRAG = 0.8
TURN = 1.5
LIFT_TAU = 8.0         # lift servo speed
VEL_SCALE = 4.0
FALL_COST = 25.0       # the suite's standard cost limit


def _rotate(heading, v_lon, v_lat):
    """Body-frame (longitudinal, lateral) velocity in the world frame."""
    c, s = torch.cos(heading), torch.sin(heading)
    return torch.stack([c * v_lon - s * v_lat, s * v_lon + c * v_lat], 1)


class AntEnv(SafeEnv):
    action_size = 8
    max_episode_steps = 500

    def __init__(self, task):
        self.task = task
        self.num_costs = task.num_costs
        self.observation_size = 21 + task.n_extras

    def _init_sim(self, n, g):
        if isinstance(self.task, CircleTask):
            theta = uniform(n, 0.0, 2 * math.pi, g)
            pos = self.task.radius * torch.stack(
                [torch.cos(theta), torch.sin(theta)], 1)
            pos[:, 0] = torch.clamp(pos[:, 0], -self.task.x_lim,
                                    self.task.x_lim)
            heading = theta + math.pi / 2
        else:
            pos = uniform((n, 2), -0.5, 0.5, g)
            heading = uniform(n, -0.3, 0.3, g)
        alpha = 0.1 * torch.randn((n, 4), generator=g, device=g.device)
        return dict(pos=pos, heading=heading, vel_body=torch.zeros_like(pos),
                    alpha=alpha, alpha_dot=torch.zeros_like(alpha),
                    lift=torch.zeros_like(alpha))

    def _step_sim(self, sim, action):
        stroke_cmd = action[:, 0::2]            # (N, 4) target sweep rate
        lift_cmd = 0.5 * (action[:, 1::2] + 1)  # (N, 4) target lift in [0, 1]
        alpha_dot = STROKE_RATE * stroke_cmd
        alpha = torch.clamp(sim["alpha"] + DT * alpha_dot, -STROKE_LIM,
                            STROKE_LIM)
        # at the stroke limit the leg stops contributing motion
        at_lim = torch.abs(alpha) >= STROKE_LIM
        eff_rate = torch.where(
            at_lim & (torch.sign(alpha_dot) == torch.sign(alpha)),
            torch.zeros_like(alpha_dot), alpha_dot)
        lift = sim["lift"] + DT * LIFT_TAU * (lift_cmd - sim["lift"])
        ground = 1.0 - lift                     # (N, 4) contact weight
        # backward sweep (negative rate) of a grounded leg: forward thrust
        thrust_i = -eff_rate * ground * THRUST / STROKE_RATE
        fwd = thrust_i.sum(1)
        # left legs (0, 1) against right legs (2, 3): yaw
        yaw = TURN * (thrust_i[:, :2].sum(1) - thrust_i[:, 2:].sum(1))
        vb = sim["vel_body"]
        v_lon = vb[:, 0] + DT * (fwd * 4.0 - DRAG * vb[:, 0])
        v_lat = vb[:, 1] * (1.0 - DT * 4.0)     # strong lateral friction
        heading = sim["heading"] + DT * yaw
        pos = sim["pos"] + DT * _rotate(heading, v_lon, v_lat)
        return dict(pos=pos, heading=heading,
                    vel_body=torch.stack([v_lon, v_lat], 1), alpha=alpha,
                    alpha_dot=eff_rate, lift=lift)

    def _world_vel(self, sim):
        return _rotate(sim["heading"], sim["vel_body"][:, 0],
                       sim["vel_body"][:, 1])

    def _obs(self, sim):
        h = sim["heading"]
        base = torch.cat([
            sim["vel_body"] / VEL_SCALE,
            torch.stack([torch.cos(h), torch.sin(h)], 1),
            torch.sin(sim["alpha"]), torch.cos(sim["alpha"]),
            sim["alpha_dot"] / STROKE_RATE, sim["lift"],
            sim["lift"].mean(1, keepdim=True)], 1)
        return torch.cat(
            [base, self.task.obs_extras(sim["pos"], self._world_vel(sim))], 1)

    def _reward_cost(self, sim_prev, sim, action):
        reward, cost = self.task.reward_cost(sim["pos"],
                                             self._world_vel(sim))
        term = self._terminated(sim).to(reward.dtype)
        # small control cost and the fall penalty
        reward = reward - 0.01 * (action ** 2).sum(1) - 5.0 * term
        # a fall is a safety violation: it rides the cost channel
        return reward, cost + FALL_COST * term[:, None]

    def _terminated(self, sim):
        # every leg lifted while moving: no support polygon
        return torch.logical_and(sim["lift"].min(1).values > 0.9,
                                 torch.abs(sim["vel_body"][:, 0]) > 0.5)


register("SafetyAntRun-v0",
         lambda **kw: AntEnv(RunTask(speed_limit=3.0, v_target=2.0, **kw)))
register("SafetyAntCircle-v0", lambda **kw: AntEnv(CircleTask(**kw)))
