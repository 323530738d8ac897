"""The port's collector against the JAX collector: deterministic (mode)
actions from JAX-made initial states and weights, with JAX's auto-reset
states handed to the port, give the same transitions and episode stats;
the episode-exact ``evaluate`` gives the same results."""

import functools

import jax
import numpy as np
import pytest
import torch
from _torch_parity import env_state, n, state_dict

from fsrl_tpu.algos.ppo_lag import PPOLag as JPPOLag
from fsrl_tpu.data.collector import evaluate as j_evaluate
from fsrl_tpu.data.collector import make_rollout_fn as j_make_rollout
from fsrl_tpu.data.collector import map_action as j_map
from fsrl_tpu.data.collector import map_action_inverse as j_map_inv
from fsrl_tpu.envs import make as jmake
from fsrl_tpu.types import EpisodeStats as JStats
from fsrl_torch.algos.ppo_lag import PPOLag
from fsrl_torch.data.collector import (evaluate, make_rollout_fn, map_action,
                                       map_action_inverse)
from fsrl_torch.envs import make
from fsrl_torch.types import EpisodeStats

torch.set_num_threads(1)

# the actor's matmuls and the env's trig functions differ in the last bits
# between the libraries; trajectories integrate that over the steps
TOL = dict(rtol=1e-4, atol=1e-4)


@functools.lru_cache(maxsize=None)
def _setup(task: str):
    jenv, tenv = jmake(task), make(task)
    jalgo = JPPOLag(jenv.observation_size, jenv.action_size,
                    num_costs=jenv.num_costs)
    params = jax.jit(jalgo.init)(jax.random.PRNGKey(3)).params
    talgo = PPOLag(tenv.observation_size, tenv.action_size,
                   num_costs=tenv.num_costs, device="cpu")
    tstate = talgo.init(state_dict=state_dict(params))
    return jenv, tenv, jalgo, params, talgo, tstate


@pytest.mark.parametrize("task", ["SafetyCarCircle-v0", "SafetyBallRun-v0"])
def test_rollout_matches_jax(task):
    jenv, tenv, jalgo, params, talgo, tstate = _setup(task)
    N, T = 16, 80       # staggered clocks: envs 14 and 15 truncate and reset
    js0 = jenv.reset_vec(jax.random.PRNGKey(1), N, stagger=True)
    rollout_j = jax.jit(j_make_rollout(jenv, jalgo.act_fn_eval, T))
    res_j = rollout_j(params, js0, JStats.init(N, jenv.num_costs),
                      jax.random.PRNGKey(2))

    # the reset states JAX's step_autoreset selects from, step by step
    @jax.jit
    def step(state):
        act, _ = jalgo.act_fn_eval(params, state.obs, None)
        a = j_map(act, jenv.action_low, jenv.action_high)
        fresh = jax.vmap(jenv.reset)(jenv.step_vec(state, a)[0].rng)
        return jenv.step_autoreset(state, a)[0], fresh

    fresh, s = [], js0
    for _ in range(T):
        s, f = step(s)
        fresh.append(env_state(f))

    res_t = make_rollout_fn(tenv, talgo.act_fn_eval, T, device="cpu")(
        tstate.params, env_state(js0), EpisodeStats.init(N, tenv.num_costs),
        torch.Generator(), reset_states=fresh)
    tr_j, tr_t = res_j.transitions, res_t.transitions
    assert int(np.asarray(tr_j.done).sum()) >= 2
    for name in ("obs", "act", "obs_next", "reward", "cost", "logp"):
        np.testing.assert_allclose(n(getattr(tr_t, name)),
                                   np.asarray(getattr(tr_j, name)),
                                   err_msg=name, **TOL)
    for name in ("terminated", "truncated"):
        np.testing.assert_array_equal(n(getattr(tr_t, name)),
                                      np.asarray(getattr(tr_j, name)))
    for name in ("n_episodes", "n_steps", "n_truncated", "ep_len"):
        np.testing.assert_array_equal(n(getattr(res_t.stats, name)),
                                      np.asarray(getattr(res_j.stats, name)))
    for name in ("sum_reward", "sum_cost", "ep_reward", "ep_cost"):
        np.testing.assert_allclose(n(getattr(res_t.stats, name)),
                                   np.asarray(getattr(res_j.stats, name)),
                                   err_msg=name, **TOL)
    np.testing.assert_allclose(n(res_t.env_state.obs),
                               np.asarray(res_j.env_state.obs), **TOL)


@pytest.mark.parametrize("task", ["SafetyCarCircle-v0",
                                  "SafetyBallCircle2C-v0"])
def test_evaluate_matches_jax(task):
    jenv, tenv, jalgo, params, talgo, tstate = _setup(task)
    n_ep = 4
    rng = jax.random.PRNGKey(7)
    out_j = jax.jit(lambda p, r: j_evaluate(jenv, jalgo.act_fn_eval, p, r,
                                            n_ep))(params, rng)
    # evaluate() resets from the second half of the key split
    js0 = jenv.reset_vec(jax.random.split(rng)[1], n_ep)
    out_t = evaluate(tenv, talgo.act_fn_eval, tstate.params,
                     torch.Generator(), n_ep, init_state=env_state(js0))
    assert set(out_t) == set(out_j)
    # episode sums of 500 per-step values that each agree to ~1e-5
    for k in out_j:
        np.testing.assert_allclose(n(out_t[k]), np.asarray(out_j[k]),
                                   err_msg=k, rtol=1e-4, atol=1e-3)
    assert float(out_t["length"]) == tenv.max_episode_steps


def test_map_action_matches_jax():
    a = np.linspace(-1.5, 1.5, 13, dtype=np.float32)
    np.testing.assert_allclose(n(map_action(torch.from_numpy(a), -2.0, 3.0)),
                               np.asarray(j_map(a, -2.0, 3.0)), rtol=1e-6)
    e = np.linspace(-2.5, 3.5, 13, dtype=np.float32)
    np.testing.assert_allclose(
        n(map_action_inverse(torch.from_numpy(e), -2.0, 3.0)),
        np.asarray(j_map_inv(e, -2.0, 3.0)), rtol=1e-6, atol=1e-7)
