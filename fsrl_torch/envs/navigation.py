"""Safety-Gymnasium-style navigation tasks, batched (port of
``fsrl_tpu/envs/navigation.py``; same formulas, same operation order).

Four families, each for the point and the car robot at levels 1 and 2:

* **Goal**: reach a goal among hazards; dense progress reward, a bonus on
  reaching it, and the goal resampled there (the episode runs on).
* **Button**: press the highlighted one of four buttons; hazards, orbiting
  gremlins and a wrong button cost; the next button is drawn on a press.
* **Push**: push a box to a goal past hazards and an impassable pillar;
  the goal is resampled when the box arrives.
* **CircleNav**: circulate a circle of radius 1.5 inside the walls
  ``|x| <= x_lim``.

Observations hold a compass to the target, its distance, the robot's ego
velocity and 16-bin pseudo-lidars. Goal, Button and Push draw in a step
(``draws_in_step``): a new goal position or button index for every env,
used where the goal was reached (JAX splits each env's key for it).
"""

from __future__ import annotations

import math

import torch

from fsrl_torch.envs.base import SafeEnv, register, uniform

DT = 0.1
ARENA = 3.0            # positions drawn in [-ARENA, ARENA]^2
GOAL_RADIUS = 0.4
LIDAR_BINS = 16
LIDAR_MAX = 3.0
GOAL_BONUS = 10.0

N_BUTTONS = 4
BUTTON_RADIUS = 0.3
GREMLIN_RADIUS = 0.25
GREMLIN_ORBIT = 0.6
GREMLIN_SPEED = 0.06   # radians per step

BOX_RADIUS = 0.25
ROBOT_RADIUS = 0.15
PILLAR_RADIUS = 0.3

CIRCLE_R_NAV = 1.5


def _norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis of 2-vectors."""
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])


def _pseudo_lidar(pos, points, radius: float):
    """16-bin inverse-distance lidar over circle centres: ``pos`` (N, 2),
    ``points`` (N, P, 2) → (N, 16), each bin the strongest reading of the
    points whose bearing falls in it (a scatter-max into zeros)."""
    rel = points - pos[:, None, :]
    dist = torch.clamp(_norm(rel) - radius, min=1e-3)
    ang = torch.atan2(rel[..., 1], rel[..., 0])            # [-pi, pi]
    bins = torch.floor((ang + math.pi) / (2 * math.pi) * LIDAR_BINS)
    bins = torch.clamp(bins.long(), 0, LIDAR_BINS - 1)
    strength = torch.clamp(1.0 - dist / LIDAR_MAX, 0.0, 1.0)
    out = torch.zeros(pos.shape[0], LIDAR_BINS, dtype=strength.dtype,
                      device=pos.device)
    return out.scatter_reduce(1, bins, strength, "amax")


def _robot_step(robot: str, pos, vel, action):
    """The shared robot dynamics: "point" is a force-controlled damped mass,
    "car" a unicycle whose ``vel`` holds (speed, heading)."""
    if robot == "point":
        acc = 10.0 * action - 1.0 * vel
        vel = vel + DT * acc
        pos = pos + DT * vel
    else:
        speed = vel[:, 0] + DT * (8.0 * action[:, 0] - vel[:, 0])
        heading = vel[:, 1] + DT * 3.0 * action[:, 1]
        vel = torch.stack([speed, heading], 1)
        pos = pos + (DT * speed)[:, None] * torch.stack(
            [torch.cos(heading), torch.sin(heading)], 1)
    return torch.clamp(pos, -1.5 * ARENA, 1.5 * ARENA), vel


def _robot_ego(robot: str, vel):
    if robot == "point":
        return vel / 5.0
    return torch.stack([vel[:, 0] / 5.0, torch.cos(vel[:, 1]),
                        torch.sin(vel[:, 1])], 1)


def _robot_world_vel(robot: str, vel):
    if robot == "point":
        return vel
    return vel[:, :1] * torch.stack([torch.cos(vel[:, 1]),
                                     torch.sin(vel[:, 1])], 1)


def _compass(rel):
    """Unit direction and distance of ``rel`` (N, 2)."""
    dist = _norm(rel)
    return rel / torch.clamp(dist, min=1e-6)[:, None], dist


def _any_within(points, pos, radius):
    """Whether any of ``points`` (N, P, 2) lies within ``radius`` (a float
    or a (P,) tensor) of ``pos`` (N, 2)."""
    return (_norm(points - pos[:, None, :]) < radius).any(1)


class _NavEnv(SafeEnv):
    action_size = 2

    def __init__(self, robot: str):
        assert robot in ("point", "car")
        self.robot = robot
        self.ego_size = 2 if robot == "point" else 3


class GoalEnv(_NavEnv):
    """Goal navigation with hazards; ``level`` sets their count and size."""

    max_episode_steps = 1000
    draws_in_step = True

    def __init__(self, robot: str = "point", level: int = 1):
        super().__init__(robot)
        self.n_hazards = 8 if level == 1 else 10
        self.hazard_radius = 0.2 if level == 1 else 0.3
        # compass (2) + distance (1) + ego velocity + hazard lidar
        self.observation_size = 3 + self.ego_size + LIDAR_BINS

    def _init_sim(self, n, g):
        return dict(pos=uniform((n, 2), -ARENA, ARENA, g),
                    vel=torch.zeros(n, 2, device=g.device),
                    goal=uniform((n, 2), -ARENA, ARENA, g),
                    hazards=uniform((n, self.n_hazards, 2), -ARENA, ARENA, g))

    def _step_sim(self, sim, action):
        pos, vel = _robot_step(self.robot, sim["pos"], sim["vel"], action)
        return dict(sim, pos=pos, vel=vel)

    def _draw_step(self, n, g):
        return dict(goal=uniform((n, 2), -ARENA, ARENA, g))

    def _resample(self, sim, draws):
        reached = _norm(sim["pos"] - sim["goal"]) < GOAL_RADIUS
        return dict(sim, goal=torch.where(reached[:, None], draws["goal"],
                                          sim["goal"]))

    def _obs(self, sim):
        compass, dist = _compass(sim["goal"] - sim["pos"])
        return torch.cat([
            compass, (dist / (2 * ARENA))[:, None],
            _robot_ego(self.robot, sim["vel"]),
            _pseudo_lidar(sim["pos"], sim["hazards"], self.hazard_radius)], 1)

    def _reward_cost(self, sim_prev, sim, action):
        # progress toward the goal that was active during the step
        d_before = _norm(sim_prev["goal"] - sim_prev["pos"])
        d_after = _norm(sim_prev["goal"] - sim["pos"])
        reached = d_after < GOAL_RADIUS
        reward = (d_before - d_after) + GOAL_BONUS * reached.float()
        cost = _any_within(sim["hazards"], sim["pos"], self.hazard_radius)
        return reward, cost.float()[:, None]


class ButtonEnv(_NavEnv):
    """Press the highlighted button among hazards and orbiting gremlins."""

    max_episode_steps = 1000
    draws_in_step = True

    def __init__(self, level: int = 1, robot: str = "point"):
        super().__init__(robot)
        self.n_hazards = 4 if level == 1 else 6
        self.n_gremlins = 4 if level == 1 else 6
        self.hazard_radius = 0.2 if level == 1 else 0.25
        # compass (2) + distance (1) + ego + lidars of buttons, hazards and
        # gremlins
        self.observation_size = 3 + self.ego_size + 3 * LIDAR_BINS

    def _init_sim(self, n, g):
        return dict(
            pos=uniform((n, 2), -ARENA, ARENA, g),
            vel=torch.zeros(n, 2, device=g.device),
            buttons=uniform((n, N_BUTTONS, 2), -ARENA, ARENA, g),
            goal_idx=torch.randint(0, N_BUTTONS, (n,), generator=g,
                                   device=g.device, dtype=torch.int32),
            hazards=uniform((n, self.n_hazards, 2), -ARENA, ARENA, g),
            gremlin_centers=uniform((n, self.n_gremlins, 2), -ARENA, ARENA,
                                    g),
            phase=torch.zeros(n, device=g.device))

    def _goal(self, sim):
        idx = sim["goal_idx"].long()
        return sim["buttons"][torch.arange(idx.shape[0], device=idx.device),
                              idx]

    def _gremlin_pos(self, sim):
        ang = sim["phase"][:, None] + torch.arange(
            self.n_gremlins, dtype=torch.float32,
            device=sim["phase"].device) * (2 * math.pi / self.n_gremlins)
        orbit = GREMLIN_ORBIT * torch.stack([torch.cos(ang), torch.sin(ang)],
                                            -1)
        return sim["gremlin_centers"] + orbit

    def _step_sim(self, sim, action):
        pos, vel = _robot_step(self.robot, sim["pos"], sim["vel"], action)
        return dict(sim, pos=pos, vel=vel, phase=sim["phase"] + GREMLIN_SPEED)

    def _draw_step(self, n, g):
        return dict(goal_idx=torch.randint(0, N_BUTTONS, (n,), generator=g,
                                           device=g.device,
                                           dtype=torch.int32))

    def _resample(self, sim, draws):
        pressed = _norm(sim["pos"] - self._goal(sim)) < BUTTON_RADIUS
        return dict(sim, goal_idx=torch.where(
            pressed, draws["goal_idx"].to(sim["goal_idx"].dtype),
            sim["goal_idx"]))

    def _obs(self, sim):
        compass, dist = _compass(self._goal(sim) - sim["pos"])
        pos = sim["pos"]
        return torch.cat([
            compass, (dist / (2 * ARENA))[:, None],
            _robot_ego(self.robot, sim["vel"]),
            _pseudo_lidar(pos, sim["buttons"], BUTTON_RADIUS),
            _pseudo_lidar(pos, sim["hazards"], self.hazard_radius),
            _pseudo_lidar(pos, self._gremlin_pos(sim), GREMLIN_RADIUS)], 1)

    def _reward_cost(self, sim_prev, sim, action):
        goal_prev = self._goal(sim_prev)
        d_before = _norm(goal_prev - sim_prev["pos"])
        d_after = _norm(goal_prev - sim["pos"])
        pressed = d_after < BUTTON_RADIUS
        reward = (d_before - d_after) + GOAL_BONUS * pressed.float()
        pos = sim["pos"]
        near_btn = _norm(sim["buttons"] - pos[:, None, :]) < BUTTON_RADIUS
        other = torch.arange(N_BUTTONS, device=pos.device)[None, :] != \
            sim_prev["goal_idx"][:, None]
        wrong = (near_btn & other).any(1)
        in_hazard = _any_within(sim["hazards"], pos, self.hazard_radius)
        hit_gremlin = _any_within(self._gremlin_pos(sim), pos, GREMLIN_RADIUS)
        cost = in_hazard | hit_gremlin | wrong
        return reward, cost.float()[:, None]


class PushEnv(_NavEnv):
    """Push a box to the goal; hazards and the pillar cost on contact."""

    max_episode_steps = 1000
    draws_in_step = True

    def __init__(self, level: int = 1, robot: str = "point"):
        super().__init__(robot)
        self.n_hazards = 2 if level == 1 else 4
        self.hazard_radius = 0.2 if level == 1 else 0.25
        # box compass (2) + distance (1) + box-to-goal compass (2) +
        # distance (1) + ego + lidar of hazards and pillar
        self.observation_size = 6 + self.ego_size + LIDAR_BINS

    def _init_sim(self, n, g):
        return dict(
            pos=uniform((n, 2), -ARENA, ARENA, g),
            vel=torch.zeros(n, 2, device=g.device),
            box=uniform((n, 2), -ARENA / 2, ARENA / 2, g),
            goal=uniform((n, 2), -ARENA, ARENA, g),
            hazards=uniform((n, self.n_hazards, 2), -ARENA, ARENA, g),
            pillar=uniform((n, 2), -ARENA, ARENA, g))

    def _step_sim(self, sim, action):
        pos, vel = _robot_step(self.robot, sim["pos"], sim["vel"], action)
        # quasi-static push: an overlapping robot moves the box along the
        # contact normal by the overlap
        rel = sim["box"] - pos
        d = _norm(rel)
        overlap = torch.clamp(BOX_RADIUS + ROBOT_RADIUS - d, min=0.0)
        box = sim["box"] + overlap[:, None] * (
            rel / torch.clamp(d, min=1e-6)[:, None])
        # the pillar is impassable: the robot is projected out of its disc
        # (along +x from its dead centre)
        prel = pos - sim["pillar"]
        pd = _norm(prel)
        pmin = PILLAR_RADIUS + ROBOT_RADIUS
        pnormal = torch.where(
            (pd > 1e-6)[:, None], prel / torch.clamp(pd, min=1e-6)[:, None],
            self._constant("x_axis", [1.0, 0.0], pos))
        pos = torch.where((pd < pmin)[:, None], sim["pillar"] + pnormal * pmin,
                          pos)
        return dict(sim, pos=pos, vel=vel, box=box)

    def _draw_step(self, n, g):
        return dict(goal=uniform((n, 2), -ARENA, ARENA, g))

    def _resample(self, sim, draws):
        reached = _norm(sim["box"] - sim["goal"]) < GOAL_RADIUS
        return dict(sim, goal=torch.where(reached[:, None], draws["goal"],
                                          sim["goal"]))

    def _obstacles(self, sim):
        return torch.cat([sim["hazards"], sim["pillar"][:, None, :]], 1)

    def _obs(self, sim):
        box_dir, d_box = _compass(sim["box"] - sim["pos"])
        goal_dir, d_goal = _compass(sim["goal"] - sim["box"])
        return torch.cat([
            box_dir, (d_box / (2 * ARENA))[:, None],
            goal_dir, (d_goal / (2 * ARENA))[:, None],
            _robot_ego(self.robot, sim["vel"]),
            _pseudo_lidar(sim["pos"], self._obstacles(sim),
                          self.hazard_radius)], 1)

    def _reward_cost(self, sim_prev, sim, action):
        # box progress toward the goal active during the step, plus robot
        # progress toward the box
        bg_before = _norm(sim_prev["goal"] - sim_prev["box"])
        bg_after = _norm(sim_prev["goal"] - sim["box"])
        rb_before = _norm(sim_prev["box"] - sim_prev["pos"])
        rb_after = _norm(sim["box"] - sim["pos"])
        reached = bg_after < GOAL_RADIUS
        reward = (bg_before - bg_after) + 0.5 * (rb_before - rb_after) \
            + GOAL_BONUS * reached.float()
        radii = self._constant(
            "radii", [self.hazard_radius] * self.n_hazards
            + [PILLAR_RADIUS + ROBOT_RADIUS + 1e-3], sim["pos"])
        cost = _any_within(self._obstacles(sim), sim["pos"], radii)
        return reward, cost.float()[:, None]


class CircleNavEnv(_NavEnv):
    """Circle following with walls at ``|x| = x_lim`` (level 2 tighter)."""

    max_episode_steps = 500

    def __init__(self, robot: str = "point", level: int = 1):
        super().__init__(robot)
        self.x_lim = 1.125 if level == 1 else 1.0
        # [x / R, y / R, (dist - R) / R, wall margin] + world velocity + ego
        self.observation_size = 6 + self.ego_size

    def _init_sim(self, n, g):
        theta = uniform(n, 0.0, 2 * math.pi, g)
        pos = CIRCLE_R_NAV * torch.stack([torch.cos(theta), torch.sin(theta)],
                                         1)
        pos[:, 0] = torch.clamp(pos[:, 0], -self.x_lim, self.x_lim)
        return dict(pos=pos, vel=torch.zeros(n, 2, device=g.device))

    def _step_sim(self, sim, action):
        pos, vel = _robot_step(self.robot, sim["pos"], sim["vel"], action)
        return dict(pos=pos, vel=vel)

    def _obs(self, sim):
        x, y = sim["pos"][:, 0], sim["pos"][:, 1]
        dist = _norm(sim["pos"])
        wvel = _robot_world_vel(self.robot, sim["vel"])
        return torch.cat([
            torch.stack([x / CIRCLE_R_NAV, y / CIRCLE_R_NAV,
                         (dist - CIRCLE_R_NAV) / CIRCLE_R_NAV,
                         (self.x_lim - torch.abs(x)) / self.x_lim], 1),
            wvel / 5.0, _robot_ego(self.robot, sim["vel"])], 1)

    def _reward_cost(self, sim_prev, sim, action):
        x, y = sim["pos"][:, 0], sim["pos"][:, 1]
        wvel = _robot_world_vel(self.robot, sim["vel"])
        dist = _norm(sim["pos"])
        reward = (-y * wvel[:, 0] + x * wvel[:, 1]) / (
            CIRCLE_R_NAV * (1.0 + torch.abs(dist - CIRCLE_R_NAV)))
        cost = (torch.abs(x) > self.x_lim).float()
        return reward, cost[:, None]


for _robot, _name in (("point", "Point"), ("car", "Car")):
    for _level in (1, 2):
        register(f"Safety{_name}Goal{_level}-v0",
                 lambda r=_robot, l=_level, **kw: GoalEnv(r, l))
        register(f"Safety{_name}Button{_level}-v0",
                 lambda r=_robot, l=_level, **kw: ButtonEnv(l, robot=r))
        register(f"Safety{_name}Push{_level}-v0",
                 lambda r=_robot, l=_level, **kw: PushEnv(l, robot=r))
        register(f"Safety{_name}Circle{_level}-v0",
                 lambda r=_robot, l=_level, **kw: CircleNavEnv(r, l))
