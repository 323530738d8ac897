"""Safety-Gymnasium's velocity-constrained MuJoCo tasks on the host path
(port of ``fsrl_tpu/envs/velocity.py``).

Standard gymnasium MuJoCo locomotion (``*-v5``) with the safety cost
``1[|x_velocity| > limit]`` in ``info["cost"]``, stepped through
:class:`fsrl_torch.envs.host_env.HostVectorEnv`. The limits are
Safety-Gymnasium's published values (half the speed of an unconstrained
PPO expert). gymnasium and mujoco are imported where an env is made.
"""

from __future__ import annotations

# Safety-Gymnasium velocity limits (m/s) and the gymnasium env under each
VELOCITY_LIMITS = {
    "SafetyHalfCheetahVelocity-v1": ("HalfCheetah-v5", 3.2096),
    "SafetyHopperVelocity-v1": ("Hopper-v5", 0.7402),
    "SafetyWalker2dVelocity-v1": ("Walker2d-v5", 2.3415),
    "SafetySwimmerVelocity-v1": ("Swimmer-v5", 0.2282),
    "SafetyAntVelocity-v1": ("Ant-v5", 2.6222),
    "SafetyHumanoidVelocity-v1": ("Humanoid-v5", 1.4149),
}


def make_velocity_env(task: str):
    """One host velocity env: a gymnasium env whose ``info["cost"]`` is
    Safety-Gymnasium's velocity constraint."""
    import gymnasium as gym

    base, limit = VELOCITY_LIMITS[task]

    class VelocityCostWrapper(gym.Wrapper):
        def step(self, action):
            obs, rew, term, trunc, info = self.env.step(action)
            vel = info.get("x_velocity", 0.0)
            info["cost"] = float(abs(vel) > limit)
            info["velocity"] = vel
            return obs, rew, term, trunc, info

    return VelocityCostWrapper(gym.make(base))


def make_velocity_vector_env(task: str, n_envs: int = 10):
    """A HostVectorEnv over ``n_envs`` instances of a velocity task."""
    from fsrl_torch.envs.host_env import HostVectorEnv
    return HostVectorEnv([lambda: make_velocity_env(task)
                          for _ in range(n_envs)])


def velocity_tasks() -> list[str]:
    """The velocity task ids (host MuJoCo)."""
    return sorted(VELOCITY_LIMITS)
