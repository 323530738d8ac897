"""The port's host-env side against the JAX package: ``HostVectorEnv``
reset / step and ``HostCollector.collect`` on CartPole with a cost signal
over the same injected actions, the velocity cost wrapper on HalfCheetah
and the raw-MuJoCo PointGoal env, 200 steps each on the same actions: bit
for bit equal (gymnasium and mujoco where installed)."""

import jax
import numpy as np
import pytest
import torch

from fsrl_torch.envs.host_env import HostCollector, HostVectorEnv
from fsrl_tpu.envs.host_env import HostCollector as JHostCollector
from fsrl_tpu.envs.host_env import HostVectorEnv as JHostVectorEnv

gym = pytest.importorskip("gymnasium")


class CostyWrapper(gym.Wrapper):
    """A synthetic ``info["cost"]`` (``tests/test_host_env.py``'s)."""

    def step(self, action):
        obs, rew, term, trunc, info = self.env.step(action)
        info["cost"] = float(abs(np.asarray(obs).ravel()[0]) > 1.0)
        return obs, rew, term, trunc, info


def make_env():
    return CostyWrapper(gym.make("CartPole-v1"))


def _pair(n):
    venvs = JHostVectorEnv([make_env] * n), HostVectorEnv([make_env] * n)
    for v in venvs:       # CartPole's {0, 1} from a policy's [-1, 1]
        v.action_low, v.action_high = 0.0, 1.0
    return venvs


def _assert_same(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_vector_env_reset_and_step_match_jax():
    jv, tv = _pair(4)
    assert (tv.n, tv.observation_size, tv.action_size, tv.discrete,
            tv.max_episode_steps) == (jv.n, jv.observation_size,
                                      jv.action_size, jv.discrete,
                                      jv.max_episode_steps)
    np.testing.assert_array_equal(tv.reset(seed=0), jv.reset(seed=0))
    rng = np.random.default_rng(0)
    for _ in range(30):
        acts = rng.integers(0, 2, 4)
        _assert_same(tv.step(acts), jv.step(acts))
    # a subset of the envs
    _assert_same(tv.step(np.array([1, 0]), ids=[3, 1]),
                 jv.step(np.array([1, 0]), ids=[3, 1]))
    np.testing.assert_array_equal(tv.reset(ids=[2]), jv.reset(ids=[2]))
    jv.close()
    tv.close()


def test_collector_episode_exact_matches_jax():
    """Both collectors, fed the same action sequence, count the same
    episodes, steps, returns and costs (surplus envs masked alike)."""
    jv, tv = _pair(3)
    jv.reset(seed=5)
    tv.reset(seed=5)
    seq = np.where(np.random.default_rng(1).random((600, 3)) < 0.5, -1.0,
                   1.0).astype(np.float32)

    def injected(to_out):
        step = [0]

        def act_fn(params, obs, rng):
            a = seq[step[0]]
            step[0] += 1
            return to_out(a), to_out(np.zeros(3, np.float32))
        return act_fn

    jstats = JHostCollector(jv).collect(injected(np.asarray), {}, 5,
                                        jax.random.PRNGKey(0))
    tstats = HostCollector(tv).collect(injected(torch.from_numpy), None, 5,
                                       torch.Generator().manual_seed(0))
    assert jstats["n/ep"] == 5
    assert tstats == jstats
    jv.close()
    tv.close()


def test_velocity_env_matches_jax():
    pytest.importorskip("mujoco")
    from fsrl_torch.envs.velocity import (VELOCITY_LIMITS, make_velocity_env,
                                          velocity_tasks)
    from fsrl_tpu.envs.velocity import VELOCITY_LIMITS as J_LIMITS
    from fsrl_tpu.envs.velocity import make_velocity_env as j_make
    assert VELOCITY_LIMITS == J_LIMITS and len(velocity_tasks()) == 6
    task = "SafetyHalfCheetahVelocity-v1"
    je, te = j_make(task), make_velocity_env(task)
    jo, _ = je.reset(seed=0)
    to, _ = te.reset(seed=0)
    np.testing.assert_array_equal(to, jo)
    rng = np.random.default_rng(2)
    for _ in range(200):
        a = rng.uniform(-1, 1, te.action_space.shape).astype(np.float32)
        jout, tout = je.step(a), te.step(a)
        np.testing.assert_array_equal(tout[0], jout[0])
        assert tout[1:4] == jout[1:4]
        assert tout[4]["cost"] == jout[4]["cost"]
        assert tout[4]["velocity"] == jout[4]["velocity"]
    je.close()
    te.close()


def test_pointgoal_mj_matches_jax():
    pytest.importorskip("mujoco")
    from fsrl_torch.envs.pointgoal_mj import PointGoalMJEnv
    from fsrl_tpu.envs.pointgoal_mj import PointGoalMJEnv as JPointGoalMJEnv
    je, te = JPointGoalMJEnv(seed=3), PointGoalMJEnv(seed=3)
    jo, _ = je.reset()
    to, _ = te.reset()
    assert to.shape == (38,)
    np.testing.assert_array_equal(to, jo)
    rng = np.random.default_rng(3)
    for _ in range(200):
        a = rng.uniform(-1, 1, 2)
        jout, tout = je.step(a), te.step(a)
        np.testing.assert_array_equal(tout[0], jout[0])
        assert tout[1:4] == jout[1:4] and tout[4] == jout[4]
    np.testing.assert_array_equal(te.hazards, je.hazards)
    np.testing.assert_array_equal(te.goal, je.goal)


def test_pointgoal_vector_env_shapes():
    pytest.importorskip("mujoco")
    from fsrl_torch.envs.pointgoal_mj import make_pointgoal_vector_env
    venv = make_pointgoal_vector_env(n_envs=2)
    obs = venv.reset(seed=0)
    assert obs.shape == (2, 38) and obs.dtype == np.float32
    assert (venv.action_size, venv.max_episode_steps) == (2, 1000)
    out = venv.step(np.zeros((2, 2)))
    assert out[0].shape == (2, 38) and out[2].shape == (2,)
    venv.close()
