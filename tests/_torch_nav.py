"""The navigation envs of the port against JAX's, for the parity test files
(``test_torch_nav_point.py``, ``test_torch_nav_car.py``): JAX's initial
states, its per-step draws and its auto-reset states are handed to the port,
and every step's observation, reward, cost, flags and next state must
agree."""

import math

import jax
import jax.numpy as jnp
import numpy as np
from _torch_parity import env_state, n, t

from fsrl_tpu.envs import make as jmake
from fsrl_torch.envs import make

# sin/cos/atan2/sqrt of the two libraries may differ in the last bit, and
# the states integrate those differences over the steps (as in
# test_torch_envs.py)
TOL = dict(rtol=1e-4, atol=1e-4)
N, STEPS = 8, 20
# a lidar point this near a bin edge (in bins) could fall into the
# neighbouring bin in one library and not the other: the scenarios hold
# none, which the test checks rather than tolerating a wrong bin
EDGE_MARGIN = 1e-5


def _family(task: str) -> str:
    for fam in ("Goal", "Button", "Push", "Circle"):
        if fam in task:
            return fam
    raise ValueError(task)


def _jax_draws(fam: str, sub):
    """The draws JAX's ``_step_sim`` makes from one env's step key."""
    if fam == "Goal":
        k_goal, _ = jax.random.split(sub)
        return dict(goal=jax.random.uniform(k_goal, (2,), minval=-3.0,
                                            maxval=3.0))
    if fam == "Button":
        return dict(goal_idx=jax.random.randint(sub, (), 0, 4))
    if fam == "Push":
        k_goal, _ = jax.random.split(sub)
        return dict(goal=jax.random.uniform(k_goal, (2,), minval=-3.0,
                                            maxval=3.0))
    return {}


def _scenario(jenv, fam: str, seed: int):
    """JAX's reset states, arranged so that the window exercises every
    branch: episodes that truncate and reset, goals reached and resampled,
    a button pressed and a wrong one, a box pushed and delivered, the pillar
    projection (also from its dead centre) and hazard contact."""
    js = jenv.reset_vec(jax.random.PRNGKey(seed), N)
    sim = {k: np.array(v) for k, v in vars(js.sim).items()}
    pos = sim["pos"]
    L = jenv.max_episode_steps
    tt = np.array([L - 3, L - 8, L - 14, L - 19, 0, 0, 0, 0], np.int32)
    if fam == "Goal":
        sim["goal"][1] = pos[1] + [0.3, 0.0]
        sim["goal"][2] = pos[2] + [0.1, 0.1]
        sim["hazards"][3, 0] = pos[3]
    elif fam == "Button":
        gi = sim["goal_idx"]
        sim["buttons"][1, gi[1]] = pos[1] + [0.1, 0.0]
        sim["buttons"][2, (gi[2] + 1) % 4] = pos[2]
        sim["hazards"][3, 0] = pos[3]
        sim["gremlin_centers"][4, 0] = pos[4] - [0.6, 0.0]
    elif fam == "Push":
        sim["pillar"][0] = pos[0]                 # dead centre (action 0)
        sim["box"][1] = pos[1] + [0.3, 0.0]       # in contact: pushed
        sim["box"][2] = sim["goal"][2] + [0.2, 0.0]   # delivered
        sim["pillar"][3] = pos[3] + [0.2, 0.0]    # projected out
        sim["hazards"][4, 0] = pos[4]
    jsim = js.sim.replace(**{k: jnp.asarray(v) for k, v in sim.items()})
    return js.replace(sim=jsim, obs=jax.vmap(jenv._obs)(jsim),
                      t=jnp.asarray(tt))


def _lidar_points(fam: str, jenv, sim):
    """Per lidar, the points it sees (N, P, 2), from a JAX sim."""
    if fam == "Goal":
        return [sim.hazards]
    if fam == "Button":
        return [sim.buttons, sim.hazards, jax.vmap(jenv._gremlin_pos)(sim)]
    if fam == "Push":
        return [jnp.concatenate([sim.hazards, sim.pillar[:, None]], 1)]
    return []


def _assert_clear_of_bin_edges(pos, points):
    """No lidar point lies within EDGE_MARGIN of a bin edge, but for points
    straight along an axis from the robot (a float32 offset of exactly 0,
    as the pillar's projection from its dead centre makes): there atan2 is
    exact (0, +-pi/2 or pi) in both libraries."""
    pos = np.asarray(pos)
    for pts in points:
        rel = np.asarray(pts) - pos[:, None]
        on_axis = (rel[..., 0] == 0) | (rel[..., 1] == 0)
        rel = rel.astype(np.float64)
        frac = (np.arctan2(rel[..., 1], rel[..., 0]) + math.pi) \
            / (2 * math.pi) * 16
        dist = np.abs(frac - np.round(frac))
        assert dist[~on_axis].min() > EDGE_MARGIN


def check_task(task: str, seed: int = 0):
    jenv, tenv = jmake(task), make(task)
    fam = _family(task)
    assert (tenv.observation_size, tenv.action_size, tenv.num_costs,
            tenv.max_episode_steps) == (jenv.observation_size,
                                        jenv.action_size, jenv.num_costs,
                                        jenv.max_episode_steps)
    assert tenv.draws_in_step == (fam != "Circle")
    js = _scenario(jenv, fam, seed)
    ts_state = env_state(js)
    np.testing.assert_allclose(n(tenv._obs(ts_state.sim)), np.asarray(js.obs),
                               rtol=1e-6, atol=1e-6)
    acts = np.random.default_rng(seed + 1).uniform(
        -1.3, 1.3, (STEPS, N, 2)).astype(np.float32)
    acts[0, 0] = 0.0

    @jax.jit
    def jstep(state, a):
        keys = jax.vmap(jax.random.split)(state.rng)     # (N, 2) keys
        draws = jax.vmap(lambda k: _jax_draws(fam, k))(keys[:, 1])
        fresh = jax.vmap(jenv.reset)(keys[:, 0])
        # the step's sim before the reset: what the lidars saw
        stepped = jenv.step_vec(state, a)[0].sim
        return (jenv.step_autoreset(state, a), draws, fresh, stepped.pos,
                _lidar_points(fam, jenv, stepped))

    resets = resampled = 0
    cost = 0.0
    goal_key = {"Goal": "goal", "Push": "goal", "Button": "goal_idx"}.get(fam)
    for i in range(STEPS):
        (js_next, ts_j), draws, fresh, pos, points = jstep(js, acts[i])
        ts_state, ts_t = tenv.step_autoreset(
            ts_state, torch_from(acts[i]), fresh=env_state(fresh),
            draws={k: t(v) for k, v in draws.items()})
        _assert_clear_of_bin_edges(pos, points)
        for name in ("obs", "reward", "cost"):
            np.testing.assert_allclose(n(getattr(ts_t, name)),
                                       np.asarray(getattr(ts_j, name)),
                                       err_msg=f"{task} {name} step {i}",
                                       **TOL)
        for name in ("terminated", "truncated"):
            np.testing.assert_array_equal(n(getattr(ts_t, name)),
                                          np.asarray(getattr(ts_j, name)))
        for k, v in vars(js_next.sim).items():
            if np.asarray(v).dtype.kind == "i":
                np.testing.assert_array_equal(n(ts_state.sim[k]),
                                              np.asarray(v))
            else:
                np.testing.assert_allclose(n(ts_state.sim[k]), np.asarray(v),
                                           err_msg=f"{task} sim.{k} step {i}",
                                           **TOL)
        np.testing.assert_array_equal(n(ts_state.t), np.asarray(js_next.t))
        done = np.asarray(ts_j.done)
        resets += int(done.sum())
        cost += float(np.asarray(ts_j.cost).sum())
        if goal_key:
            moved = np.asarray(getattr(js_next.sim, goal_key)
                               != getattr(js.sim, goal_key))
            resampled += int((moved.reshape(N, -1).any(1) & ~done).sum())
        js = js_next
    # the window truncated and reset four episodes, and (but for
    # CircleNav) resampled a goal and paid some cost
    assert resets == 4
    if goal_key:
        assert resampled >= 1 and cost >= 1.0, (resampled, cost)


def torch_from(a):
    import torch
    return torch.from_numpy(np.ascontiguousarray(a))
