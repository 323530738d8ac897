"""The navigation tasks' semantics on the port, as ``tests/test_new_envs.py``
checks them on the JAX envs, from the same initial states (JAX's reset of
the same keys): progress reward and hazard cost (Goal), the press bonus and
the wrong-button cost (Button), the box pushed toward its goal and the
pillar's cost and projection (Push). The draws of a step come from the
port's own generator here."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from _torch_parity import env_state, n

from fsrl_tpu.envs import make as jmake
from fsrl_torch.envs import make
from fsrl_torch.envs.navigation import ARENA, GOAL_RADIUS, _norm

torch.set_num_threads(1)


def _start(task, seed):
    """The port's env and JAX's reset state of ``PRNGKey(seed)`` (the state
    ``env.reset`` gives ``test_new_envs.py``), as a batch of one."""
    jenv = jmake(task)
    js = jax.vmap(jenv.reset)(jnp.stack([jax.random.PRNGKey(seed)]))
    return make(task), env_state(js), torch.Generator().manual_seed(seed)


def test_goal_env_reward_progress_and_hazard_cost():
    env, state, g = _start("SafetyPointGoal1-v0", 3)
    total = 0.0
    for _ in range(100):    # straight toward the goal
        act = torch.clamp(state.sim["goal"] - state.sim["pos"], -1, 1)
        state, ts = env.step(state, act, g)
        total += float(ts.reward.sum())
    assert total > 0.5
    # standing on a hazard costs
    sim = dict(state.sim, pos=state.sim["hazards"][:, 0].clone(),
               vel=torch.zeros(1, 2))
    _, ts = env.step(type(state)(sim=sim, obs=state.obs, t=state.t),
                     torch.zeros(1, 2), g)
    assert float(ts.cost.sum()) == 1.0


def test_goal_is_drawn_again_where_reached():
    """The port's own draws: a reached goal moves to a fresh point of the
    arena, an unreached one stays."""
    env = make("SafetyCarGoal2-v0")
    g = torch.Generator().manual_seed(0)
    state = env.reset(64, g)
    reached = torch.arange(64) % 2 == 0
    goal = torch.where(reached[:, None], state.sim["pos"] + 0.05,
                       state.sim["goal"])
    state.sim["goal"] = goal
    nxt, _ = env.step(state, torch.zeros(64, 2), g)
    hit = _norm(nxt.sim["pos"] - goal) < GOAL_RADIUS
    assert bool(hit[reached].all())
    moved = (nxt.sim["goal"] != goal).any(1)
    assert torch.equal(moved, hit)
    assert float(nxt.sim["goal"].abs().max()) <= ARENA


def test_button_env_goal_press_and_wrong_button_cost():
    env, state, g = _start("SafetyPointButton1-v0", 5)
    total = 0.0
    for _ in range(200):
        act = torch.clamp(env._goal(state.sim) - state.sim["pos"], -1, 1)
        state, ts = env.step(state, act, g)
        total += float(ts.reward.sum())
    assert total > 0.5    # progress and the press bonus are reachable
    # parking on a button that is not the goal costs every step
    wrong = (state.sim["goal_idx"].long() + 1) % 4
    sim = dict(state.sim, pos=state.sim["buttons"][0, wrong].clone(),
               vel=torch.zeros(1, 2))
    _, ts = env.step(type(state)(sim=sim, obs=state.obs, t=state.t),
                     torch.zeros(1, 2), g)
    assert float(ts.cost.sum()) == 1.0


def test_push_env_box_moves_and_pillar_costs():
    env, state, g = _start("SafetyPointPush1-v0", 7)
    sim = state.sim
    to_goal = (sim["goal"] - sim["box"]) / _norm(
        sim["goal"] - sim["box"])[:, None]
    state.sim = dict(sim, pos=sim["box"] - 0.35 * to_goal,
                     vel=torch.zeros(1, 2))
    d0 = float(_norm(state.sim["goal"] - state.sim["box"]))
    for _ in range(150):
        d = state.sim["box"] - state.sim["pos"]
        act = torch.clamp(3.0 * d + (state.sim["goal"] - state.sim["box"]),
                          -1, 1)
        state, _ = env.step(state, act, g)
    assert float(_norm(state.sim["goal"] - state.sim["box"])) < d0 - 0.2
    # standing inside the pillar's contact radius costs, and the robot is
    # projected out of the pillar (along +x from its dead centre)
    pillar = state.sim["pillar"].clone()
    sim = dict(state.sim, pos=pillar.clone(), vel=torch.zeros(1, 2))
    nxt, ts = env.step(type(state)(sim=sim, obs=state.obs, t=state.t),
                       torch.zeros(1, 2), g)
    assert float(ts.cost.sum()) == 1.0
    np.testing.assert_allclose(n(nxt.sim["pos"] - pillar), [[0.45, 0.0]],
                               atol=1e-6)
