"""Learning-rate schedules in the port's flat Adam: torch twins of
``tests/test_lr_schedule.py``, each held against optax on the same
inputs."""

import jax.numpy as jnp
import numpy as np
import optax
import torch

from fsrl_tpu.algos.common import make_optimizer as j_make_optimizer
from fsrl_tpu.algos.common import per_update_schedule as j_per_update
from fsrl_torch.algos.common import (linear_schedule, make_optimizer,
                                     per_update_schedule)
from fsrl_torch.algos.ppo_lag import PPOLag
from fsrl_torch.data.collector import make_rollout_fn
from fsrl_torch.envs import make
from fsrl_torch.types import EpisodeStats

torch.set_num_threads(1)


def test_schedule_decays_update_magnitude():
    """With linear decay to zero Adam's applied step shrinks to ~0 by the
    last gradient step, and every step equals optax's (the schedule is read
    at the count before the increment)."""
    tx = make_optimizer(linear_schedule(1e-2, 0.0, transition_steps=100))
    jtx = j_make_optimizer(optax.linear_schedule(1e-2, 0.0,
                                                 transition_steps=100))
    params, grads = torch.ones(4), torch.ones(4)
    state = tx.init(params)
    jparams, jgrads = {"w": jnp.ones((4,))}, {"w": jnp.ones((4,))}
    jstate = jtx.init(jparams)
    deltas = []
    for _ in range(100):
        updates, state = tx.update(grads, state)
        jupd, jstate = jtx.update(jgrads, jstate, jparams)
        np.testing.assert_allclose(updates.numpy(), np.asarray(jupd["w"]),
                                   rtol=1e-5, atol=1e-9)
        deltas.append(float(updates.abs().max()))
        params = params + updates
    assert int(state.count) == 100
    assert deltas[0] > 9e-3            # the first step sees lr(0), not lr(1)
    assert deltas[5] > 1e-3            # early: near full lr
    assert deltas[-1] < deltas[5] / 20  # late: decayed away


def test_per_update_schedule_counts_in_update_units():
    sched = per_update_schedule(
        linear_schedule(1.0, 0.0, transition_steps=10),
        grad_steps_per_update=16)
    jsched = j_per_update(optax.linear_schedule(1.0, 0.0, 10), 16)
    # all 16 grad steps of update 0 see lr(0); update 5's see lr(5)
    assert float(sched(0)) == float(sched(15)) == 1.0
    assert abs(float(sched(5 * 16)) - 0.5) < 1e-6
    assert float(sched(10 * 16)) == 0.0
    for count in (0, 15, 16, 80, 159, 160, 1000):
        assert float(sched(torch.tensor(count, dtype=torch.int32))) == \
            float(jsched(jnp.asarray(count, jnp.int32)))
    # evaluated on the count's device, without a host value
    assert isinstance(sched(torch.tensor(3)), torch.Tensor)


def test_ppo_lag_accepts_schedule():
    """PPOLag trains with a schedule as ``lr`` and advances it by its
    gradient-step count."""
    env = make("SafetyBallRun-v0")
    sched = per_update_schedule(
        linear_schedule(5e-4, 0.0, transition_steps=4),
        grad_steps_per_update=2 * 2)
    algo = PPOLag(env.observation_size, env.action_size, cost_limit=50.0,
                  lr=sched, hidden_sizes=(32, 32), repeat=2, n_minibatches=2,
                  device="cpu")
    g = torch.Generator().manual_seed(0)
    state = algo.init(seed=0)
    rollout = make_rollout_fn(env, algo.act_fn, 32, device="cpu")
    res = rollout(state.params, env.reset_vec(8, g),
                  EpisodeStats.init(8, env.num_costs), g)
    before = state.flat.clone()
    state, metrics = algo.update(state, res.transitions, res.stats.mean_cost,
                                 res.stats.n_episodes, g)
    assert int(state.gradient_steps) == 4
    assert int(state.opt_state.count) == 4
    assert bool(torch.isfinite(metrics["loss/total"]))
    assert float((state.flat - before).abs().max()) > 1e-5
    # schedule position after one update = lr(1)
    assert abs(float(sched(state.gradient_steps)) - 5e-4 * 0.75) < 1e-9
    # a second update runs at lr(1): its steps are at most 0.75 of lr(0)'s
    res = rollout(state.params, res.env_state, res.stats, g)
    before = state.flat.clone()
    state, _ = algo.update(state, res.transitions, res.stats.mean_cost,
                           res.stats.n_episodes, g)
    assert int(state.opt_state.count) == 8
