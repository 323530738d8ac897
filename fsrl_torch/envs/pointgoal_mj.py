"""SafetyPointGoal1 on raw MuJoCo 3.x, a host env (port of
``fsrl_tpu/envs/pointgoal_mj.py``; the same scene, task logic and random
draws, so both packages step it bit for bit alike from one seed).

Safety-Gymnasium's navigation scenes are plain MuJoCo models plus
pure-Python task logic (goal resampling, virtual hazard circles, lidar
pseudo-observations); the hazards never collide, so the only physics body
is the point robot. This module rebuilds that stack on the raw ``mujoco``
bindings: a velocity-damped cylinder driven by a body-frame forward force
and a z-torque on an infinite plane. 8 hazard circles (radius 0.2, cost 1
a step inside), a goal circle (radius 0.3, +1 on reach; the goal moves and
the episode goes on), reward ``d_prev - d_now``, truncation at 1000 steps,
placements in [-1.5, 1.5]^2. The observation (38 floats) carries the
reference sensor suite's information: body-frame velocity and yaw rate,
the goal's compass and ``exp(-distance)``, and 16-bin goal and hazard
lidars. Its own ``np.random.default_rng(seed)`` draws every placement.

Known deviation from the reference: the robot's mass, damping and gears
are set for Safety-Gymnasium-like speed (the arena crossed in ~2-3 s), not
copied from its XML.
"""

from __future__ import annotations

import math

import numpy as np

POINT_XML = """
<mujoco model="pointgoal">
  <option timestep="0.002" integrator="implicitfast"/>
  <worldbody>
    <geom name="floor" type="plane" size="0 0 0.1" friction="1 0.01 0.001"/>
    <body name="robot" pos="0 0 0.1">
      <joint name="jx" type="slide" axis="1 0 0" damping="1.0"/>
      <joint name="jy" type="slide" axis="0 1 0" damping="1.0"/>
      <joint name="jz" type="hinge" axis="0 0 1" damping="0.05"/>
      <geom name="body" type="cylinder" size="0.1 0.05" mass="1.0"
            friction="0.1 0.01 0.001"/>
    </body>
  </worldbody>
</mujoco>
"""

N_HAZARDS = 8
HAZARD_R = 0.2
GOAL_R = 0.3
EXTENT = 1.5
LIDAR_BINS = 16
LIDAR_MAX = 3.0
FRAME_SKIP = 10           # control at 20 ms like safety-gymnasium
FORCE_GEAR = 2.0
TORQUE_GEAR = 0.15
EP_LEN = 1000


def _lidar(rel_xy: np.ndarray, theta: float) -> np.ndarray:
    """16-bin max-pooled proximity lidar in the robot frame (the
    safety-gymnasium pseudo-lidar: bin by bearing, intensity 1 - d/max)."""
    out = np.zeros(LIDAR_BINS, np.float64)
    if rel_xy.size == 0:
        return out
    d = np.linalg.norm(rel_xy, axis=1)
    bearing = np.arctan2(rel_xy[:, 1], rel_xy[:, 0]) - theta
    idx = np.floor(((bearing % (2 * math.pi)) / (2 * math.pi)) * LIDAR_BINS
                   ).astype(int) % LIDAR_BINS
    inten = np.clip(1.0 - d / LIDAR_MAX, 0.0, 1.0)
    np.maximum.at(out, idx, inten)
    return out


class PointGoalMJEnv:
    """A Gymnasium-API env (duck-typed) for
    :class:`fsrl_torch.envs.host_env.HostVectorEnv`."""

    metadata: dict = {}

    def __init__(self, seed: int | None = None):
        import mujoco
        self._mujoco = mujoco
        self.model = mujoco.MjModel.from_xml_string(POINT_XML)
        self.data = mujoco.MjData(self.model)
        self.rng = np.random.default_rng(seed)
        self.hazards = np.zeros((N_HAZARDS, 2))
        self.goal = np.zeros(2)
        self.t = 0
        self._last_dist = 0.0
        obs = self._obs()
        # gym-like spaces (duck-typed; HostVectorEnv only needs shapes)
        from gymnasium.spaces import Box
        self.observation_space = Box(-np.inf, np.inf, obs.shape, np.float64)
        self.action_space = Box(-1.0, 1.0, (2,), np.float64)
        self.spec = type("Spec", (), {"max_episode_steps": EP_LEN})()

    # ------------------------------------------------------------------
    def _sample_positions(self, n, keepout, avoid=(), avoid_r=0.0):
        pts = []
        for _ in range(n):
            for _try in range(1000):
                p = self.rng.uniform(-EXTENT, EXTENT, 2)
                ok = all(np.linalg.norm(p - q) > keepout for q in pts)
                ok = ok and all(np.linalg.norm(p - np.asarray(a)) >
                                keepout + avoid_r for a in avoid)
                if ok:
                    break
            pts.append(p)
        return np.asarray(pts)

    def _resample_goal(self):
        self.goal = self._sample_positions(
            1, 0.4, avoid=list(self.hazards) + [self.data.qpos[:2]],
            avoid_r=HAZARD_R)[0]
        self._last_dist = float(np.linalg.norm(
            self.data.qpos[:2] - self.goal))

    def reset(self, seed=None, options=None):
        if seed is not None:
            self.rng = np.random.default_rng(seed)
        mujoco = self._mujoco
        mujoco.mj_resetData(self.model, self.data)
        start = self.rng.uniform(-EXTENT, EXTENT, 2)
        self.data.qpos[0:2] = start
        self.data.qpos[2] = self.rng.uniform(-math.pi, math.pi)
        self.hazards = self._sample_positions(
            N_HAZARDS, 2.2 * HAZARD_R, avoid=[start], avoid_r=0.35)
        self._resample_goal()
        self.t = 0
        mujoco.mj_forward(self.model, self.data)
        return self._obs(), {}

    # ------------------------------------------------------------------
    def _obs(self) -> np.ndarray:
        x, y, theta = self.data.qpos[0], self.data.qpos[1], self.data.qpos[2]
        vx, vy, om = self.data.qvel[0], self.data.qvel[1], self.data.qvel[2]
        c, s = math.cos(theta), math.sin(theta)
        # body-frame velocimeter + gyro
        bvx, bvy = c * vx + s * vy, -s * vx + c * vy
        rel_goal = (self.goal - self.data.qpos[:2])[None]
        rel_haz = self.hazards - self.data.qpos[:2]
        d_goal = float(np.linalg.norm(rel_goal))
        # goal compass in robot frame (unit vector)
        gx, gy = rel_goal[0] / max(d_goal, 1e-6)
        comp = np.array([c * gx + s * gy, -s * gx + c * gy])
        return np.concatenate([
            [bvx, bvy, om],
            comp, [math.exp(-d_goal)],
            _lidar(rel_goal, theta),
            _lidar(rel_haz, theta),
        ]).astype(np.float64)

    def step(self, action):
        mujoco = self._mujoco
        a = np.clip(np.asarray(action, np.float64), -1.0, 1.0)
        theta = self.data.qpos[2]
        fx = FORCE_GEAR * a[0] * math.cos(theta)
        fy = FORCE_GEAR * a[0] * math.sin(theta)
        tz = TORQUE_GEAR * a[1]
        for _ in range(FRAME_SKIP):
            self.data.qfrc_applied[0] = fx
            self.data.qfrc_applied[1] = fy
            self.data.qfrc_applied[2] = tz
            mujoco.mj_step(self.model, self.data)
        self.t += 1

        pos = self.data.qpos[:2]
        dist = float(np.linalg.norm(pos - self.goal))
        reward = self._last_dist - dist
        self._last_dist = dist
        goal_met = dist <= GOAL_R
        if goal_met:
            reward += 1.0
            self._resample_goal()
        cost = float(np.any(np.linalg.norm(self.hazards - pos, axis=1)
                            <= HAZARD_R))
        info = {"cost": cost, "goal_met": goal_met}
        truncated = self.t >= EP_LEN
        return self._obs(), reward, False, truncated, info

    def close(self):
        pass


def make_pointgoal_vector_env(n_envs: int = 10):
    """HostVectorEnv over ``n_envs`` raw-MuJoCo PointGoal1 instances."""
    from fsrl_torch.envs.host_env import HostVectorEnv
    return HostVectorEnv([lambda: PointGoalMJEnv() for _ in range(n_envs)])
