"""Drone agent: simplified planar-attitude quadrotor with four rotor
inputs, batched (port of ``fsrl_tpu/envs/drone.py``): SafetyDroneRun-v0 /
SafetyDroneCircle-v0.

Rigid body with roll / pitch attitude and rotor mixing to (thrust, roll
torque, pitch torque); yaw is ignored. Gravity must be compensated actively,
and the episode terminates on ground contact (z <= 0) or above four times
the target altitude: the one agent of the family with a true ``terminated``
signal. A crash charges the cost channel ``CRASH_COST`` on the terminating
step, so dying fast is never a feasible shortcut.
"""

from __future__ import annotations

import math

import torch

from fsrl_torch.envs.base import SafeEnv, register, uniform
from fsrl_torch.envs.tasks import CircleTask, RunTask

DT = 0.05
G = 9.81
THRUST_MAX = 2.0 * G      # total thrust at action = +1
TILT_RATE = 4.0           # attitude torque scale
ANG_DRAG = 2.0
# anisotropic linear drag: rotor downwash damps vertical motion far more
# than horizontal, which keeps hover recoverable under exploration noise.
# A tuple: the tensor is made on the env's device inside the step
LIN_DRAG = (0.3, 0.3, 1.6)
Z_TARGET = 2.0
CRASH_COST = 25.0         # the suite's standard cost limit
VEL_SCALE = 5.0


class DroneEnv(SafeEnv):
    action_size = 4  # rotor thrusts in [-1, 1] (mapped to [0, 1])
    max_episode_steps = 500

    def __init__(self, task):
        self.task = task
        self.num_costs = task.num_costs
        self.observation_size = 10 + task.n_extras

    def _init_sim(self, n, g):
        if isinstance(self.task, CircleTask):
            theta = uniform(n, 0.0, 2 * math.pi, g)
            xy = self.task.radius * torch.stack(
                [torch.cos(theta), torch.sin(theta)], 1)
            xy[:, 0] = torch.clamp(xy[:, 0], -self.task.x_lim,
                                   self.task.x_lim)
        else:
            xy = uniform((n, 2), -0.5, 0.5, g)
        pos = torch.cat([xy, torch.full_like(xy[:, :1], Z_TARGET)], 1)
        vel = 0.1 * torch.randn((n, 3), generator=g, device=g.device)
        zeros = torch.zeros_like(xy)
        return dict(pos=pos, vel=vel, att=zeros, angvel=zeros.clone())

    def _step_sim(self, sim, action):
        rotors = 0.5 * (action + 1.0)  # [0, 1]
        thrust = THRUST_MAX * rotors.mean(1)
        r0, r1, r2, r3 = rotors.unbind(1)
        # X-configuration mixing for the roll / pitch torques
        roll_t = TILT_RATE * (r0 + r2 - r1 - r3) * 0.5
        pitch_t = TILT_RATE * (r0 + r1 - r2 - r3) * 0.5
        angvel = sim["angvel"] + DT * (torch.stack([roll_t, pitch_t], 1)
                                       - ANG_DRAG * sim["angvel"])
        att = torch.clamp(sim["att"] + DT * angvel, -0.8, 0.8)
        roll, pitch = att[:, 0], att[:, 1]
        # small-angle body-z thrust direction in the world frame
        body_z = torch.stack([torch.sin(pitch),
                              -torch.sin(roll) * torch.cos(pitch),
                              torch.cos(roll) * torch.cos(pitch)], 1)
        gravity = action.new_tensor([0.0, 0.0, G])
        acc = (thrust[:, None] * body_z - gravity
               - action.new_tensor(LIN_DRAG) * sim["vel"])
        vel = sim["vel"] + DT * acc
        pos = sim["pos"] + DT * vel
        return dict(pos=pos, vel=vel, att=att, angvel=angvel)

    def _obs(self, sim):
        pos, vel = sim["pos"], sim["vel"]
        base = torch.cat([
            vel / VEL_SCALE, sim["att"], sim["angvel"] / 4.0,
            torch.stack([(pos[:, 2] - Z_TARGET) / Z_TARGET,
                         torch.tanh(pos[:, 0] / 10.0),
                         torch.tanh(pos[:, 1] / 10.0)], 1)], 1)
        return torch.cat(
            [base, self.task.obs_extras(pos[:, :2], vel[:, :2])], 1)

    def _reward_cost(self, sim_prev, sim, action):
        reward, cost = self.task.reward_cost(sim["pos"][:, :2],
                                             sim["vel"][:, :2])
        term = self._terminated(sim).to(reward.dtype)
        # altitude-hold shaping and the crash penalty
        reward = (reward - 0.1 * torch.abs(sim["pos"][:, 2] - Z_TARGET)
                  - 10.0 * term)
        # a crash is a safety violation: it rides the cost channel
        return reward, cost + CRASH_COST * term[:, None]

    def _terminated(self, sim):
        z = sim["pos"][:, 2]
        return torch.logical_or(z <= 0.0, z > 4.0 * Z_TARGET)


register("SafetyDroneRun-v0", lambda **kw: DroneEnv(RunTask(**kw)))
register("SafetyDroneCircle-v0", lambda **kw: DroneEnv(CircleTask(**kw)))
