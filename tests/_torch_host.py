"""A deterministic host env without gymnasium for the host-trainer parity
tests, and a pair of vector envs over it (the JAX package's and the
port's)."""

from types import SimpleNamespace

import numpy as np

from fsrl_torch.envs.host_env import HostVectorEnv
from fsrl_tpu.envs.host_env import HostVectorEnv as JHostVectorEnv

D, A, EP = 5, 3, 5   # observation and action widths, episode length
# Humanoid-v5's widths (SafetyHumanoidVelocity-v1), for the update at the
# widest task of the velocity suite
HUMANOID = (348, 17)


class StubEnv:
    """Env ``i``: the observation is a function of ``(i, k, resets)``
    where ``k`` is the step within the episode (0 after a reset: its last
    entry is then -1, a marker of the reset observation); the reward and
    cost do not depend on the action. Every episode is truncated after
    ``EP`` steps, but env 1's are terminated at step 3; env 2 reports no
    cost; env 3 speaks the old 4-tuple API. Widths ``d > D`` append
    ``d - D`` entries ``sin(j + i + 0.3 k + resets)``, j their index."""

    def __init__(self, i: int, d: int = D, a: int = A):
        self.i, self.k, self.resets = i, 0, 0
        self.d, self.a = d, a
        self.observation_space = SimpleNamespace(shape=(d,))
        self.action_space = SimpleNamespace(
            shape=(a,), low=np.full(a, -2.0, np.float32),
            high=np.full(a, 2.0, np.float32))
        self.spec = SimpleNamespace(max_episode_steps=EP)

    def obs(self) -> np.ndarray:
        head = [self.i, self.k, self.resets, 0.1 * self.i * self.k,
                -1.0 if self.k == 0 else 1.0]
        tail = np.sin(np.arange(self.d - D) + self.i + 0.3 * self.k
                      + self.resets)
        return np.concatenate([head, tail]).astype(np.float32)

    def reset(self, seed=None, options=None):
        if seed is not None:
            self.resets = 10 * seed
        self.k = 0
        self.resets += 1
        return self.obs(), {}

    def step(self, action):
        assert np.shape(action) == (self.a,)
        self.k += 1
        rew = float(self.i + 0.5 * self.k)
        info = {} if self.i == 2 else {"cost": float(self.k % 3 == 0)}
        term = self.i == 1 and self.k == 3
        trunc = self.k >= EP and not term
        if self.i == 3:
            info["TimeLimit.truncated"] = trunc
            return self.obs(), rew, term or trunc, info
        return self.obs(), rew, term, trunc, info

    def close(self):
        pass


def stub_venvs(n: int = 4, d: int = D, a: int = A):
    """The JAX package's and the port's HostVectorEnv over ``n`` stub
    envs each, of observation width ``d`` and action width ``a``."""
    fns = [lambda i=i: StubEnv(i, d, a) for i in range(n)]
    return JHostVectorEnv(fns), HostVectorEnv(fns)
