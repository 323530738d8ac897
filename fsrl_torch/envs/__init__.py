"""Batched safe-RL environments (registration side effects)."""

from fsrl_torch.envs.base import (EnvState, SafeEnv, make, register,
                                  registered_tasks)
from fsrl_torch.envs import ant, ball, car, drone, navigation  # noqa: F401,E501

__all__ = ["EnvState", "SafeEnv", "make", "register", "registered_tasks"]
