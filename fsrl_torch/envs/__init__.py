"""Batched safe-RL environments (registration side effects)."""

from fsrl_torch.envs.base import EnvState, SafeEnv, make, register
from fsrl_torch.envs import ball, car  # noqa: F401  (registers tasks)

__all__ = ["EnvState", "SafeEnv", "make", "register"]
