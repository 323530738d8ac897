"""The port's batched envs against the JAX envs: same initial states (made
by JAX), same actions, same observations, rewards, costs and flags."""

import jax
import numpy as np
import pytest
import torch
from _torch_parity import env_state, n, t

from fsrl_tpu.envs import make as jmake
from fsrl_tpu.types import EpisodeStats as JStats
from fsrl_torch.envs import make
from fsrl_torch.types import EpisodeStats

torch.set_num_threads(1)

TASKS = ["SafetyCarRun-v0", "SafetyCarCircle-v0", "SafetyBallRun-v0",
         "SafetyBallCircle-v0", "SafetyBallCircle2C-v0",
         "SafetyDroneRun-v0", "SafetyDroneCircle-v0", "SafetyAntRun-v0",
         "SafetyAntCircle-v0"]
# sin/cos/tanh of the two libraries may differ in the last bit, and the
# states integrate those differences over the steps: 1e-4 over 120 steps
TOL = dict(rtol=1e-4, atol=1e-4)


def _check_ts(ts_t, ts_j, step):
    for name in ("obs", "reward", "cost"):
        np.testing.assert_allclose(n(getattr(ts_t, name)),
                                   np.asarray(getattr(ts_j, name)),
                                   err_msg=f"{name} at step {step}", **TOL)
    for name in ("terminated", "truncated"):
        np.testing.assert_array_equal(n(getattr(ts_t, name)),
                                      np.asarray(getattr(ts_j, name)))


@pytest.mark.parametrize("task", TASKS)
def test_step_matches_jax(task):
    jenv, tenv = jmake(task), make(task)
    assert (tenv.observation_size, tenv.action_size, tenv.num_costs) == \
        (jenv.observation_size, jenv.action_size, jenv.num_costs)
    N, steps = 16, 120
    js = jenv.reset_vec(jax.random.PRNGKey(0), N)
    ts_state = env_state(js)
    # the port's observation of JAX's initial sim equals JAX's
    np.testing.assert_allclose(n(tenv._obs(ts_state.sim)), np.asarray(js.obs),
                               rtol=1e-6, atol=1e-6)
    # actions beyond [-1, 1] exercise the env's clip
    acts = np.random.default_rng(1).uniform(
        -1.3, 1.3, (steps, N, jenv.action_size)).astype(np.float32)
    jstep = jax.jit(jenv.step_vec)
    for i in range(steps):
        js, ts_j = jstep(js, acts[i])
        ts_state, ts_t = tenv.step(ts_state, torch.from_numpy(acts[i]))
        _check_ts(ts_t, ts_j, i)
    np.testing.assert_array_equal(n(ts_state.t), np.asarray(js.t))


# low: mean rotor command -0.5, a quarter of hover thrust, so every drone
# crashes within a second and again after its reset; lift: every ant leg
# lifted while the stroke drives the torso, so the ants fall
AUTORESET = {"SafetyCarCircle-v0": None, "SafetyBallRun-v0": None,
             "SafetyDroneRun-v0": "low", "SafetyAntRun-v0": "lift"}


@pytest.mark.parametrize("task", list(AUTORESET))
def test_step_autoreset_and_stats_match_jax(task):
    """Staggered clocks make several envs truncate and reset inside the
    window; the reset states JAX draws are handed to the port. The drone
    and the ant also terminate (crash, fall) and pay the crash cost."""
    jenv, tenv = jmake(task), make(task)
    N, steps = 16, 100
    js = jenv.reset_vec(jax.random.PRNGKey(2), N, stagger=True)
    ts_state = env_state(js)
    jst, tst = JStats.init(N, jenv.num_costs), EpisodeStats.init(
        N, tenv.num_costs)
    acts = np.random.default_rng(3).uniform(
        -1, 1, (steps, N, jenv.action_size)).astype(np.float32)
    if AUTORESET[task] == "low":
        acts = 0.5 * acts - 0.5
    elif AUTORESET[task] == "lift":
        acts[:, :, 1::2] = 1.0                      # lift every leg
        acts[:, :, 0::2] = -np.abs(acts[:, :, 0::2])  # sweep backward

    @jax.jit
    def jstep(state, a):
        # the fresh states step_autoreset selects where done
        fresh = jax.vmap(jenv.reset)(jenv.step_vec(state, a)[0].rng)
        return jenv.step_autoreset(state, a), fresh

    resets = 0
    for i in range(steps):
        (js, ts_j), fresh = jstep(js, acts[i])
        ts_state, ts_t = tenv.step_autoreset(
            ts_state, torch.from_numpy(acts[i]), fresh=env_state(fresh))
        _check_ts(ts_t, ts_j, i)
        np.testing.assert_allclose(n(ts_state.obs), np.asarray(js.obs),
                                   **TOL)
        np.testing.assert_array_equal(n(ts_state.t), np.asarray(js.t))
        jst, tst = jst.update(ts_j), tst.update(ts_t)
        resets += int(np.asarray(ts_j.done).sum())
        term = n(ts_t.terminated)
        if term.any():
            # the crash rides the cost channel on the terminating step
            assert float(n(ts_t.cost)[term].min()) >= 25.0
    assert resets >= 3
    if AUTORESET[task]:
        assert int(tst.n_terminated) >= 3
    for name in ("ep_reward", "ep_cost", "sum_reward", "sum_cost",
                 "sum_len"):
        np.testing.assert_allclose(n(getattr(tst, name)),
                                   np.asarray(getattr(jst, name)),
                                   err_msg=name, **TOL)
    for name in ("ep_len", "n_episodes", "n_steps", "n_terminated",
                 "n_truncated"):
        np.testing.assert_array_equal(n(getattr(tst, name)),
                                      np.asarray(getattr(jst, name)))
    np.testing.assert_allclose(n(tst.mean_cost), np.asarray(jst.mean_cost),
                               **TOL)
    r_t, r_j = tst.reset_aggregates(), jst.reset_aggregates()
    assert int(r_t.n_episodes) == int(r_j.n_episodes) == 0
    np.testing.assert_allclose(n(r_t.ep_reward), np.asarray(r_j.ep_reward),
                               **TOL)


@pytest.mark.parametrize("N", [1, 7, 16, 1000])
def test_reset_vec_stagger_clocks_match(N):
    jenv, tenv = jmake("SafetyCarCircle-v0"), make("SafetyCarCircle-v0")
    js = jenv.reset_vec(jax.random.PRNGKey(0), N, stagger=True)
    ts_state = tenv.reset_vec(N, torch.Generator().manual_seed(0),
                              stagger=True)
    np.testing.assert_array_equal(n(ts_state.t), np.asarray(js.t))
    assert ts_state.obs.shape == (N, tenv.observation_size)


def test_reset_draws_are_in_the_spawn_region():
    """The port draws its own reset states (another generator than JAX's):
    check the distribution's support instead of the values."""
    g = torch.Generator().manual_seed(0)
    car = make("SafetyCarCircle-v0").reset(4096, g)
    r = torch.linalg.norm(car.sim["pos"], dim=1)
    assert float(car.sim["pos"][:, 0].abs().max()) <= 4.0
    assert float(r.max()) <= 7.0 + 1e-5
    ball = make("SafetyBallRun-v0").reset(4096, g)
    assert float(ball.sim["pos"].abs().max()) <= 0.5
    assert float(ball.sim["vel"].abs().max()) <= 0.1
    assert t(np.zeros(1)).dtype == torch.float32


def test_make_unknown_task_raises():
    with pytest.raises(KeyError):
        make("Bogus-v0")
