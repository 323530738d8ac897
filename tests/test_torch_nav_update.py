"""One f32 PPO-Lag update on a navigation task (SafetyPointGoal1-v0, an
observation of 21: K2's widened envelope) against the JAX package's, on a
segment JAX collected there, from the same weights and shuffles."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import n, state_dict, t, transition
from test_torch_ppo_lag import _jax_perms

from fsrl_tpu.algos.ppo_lag import PPOLag as JPPOLag
from fsrl_tpu.data.collector import make_rollout_fn as j_make_rollout
from fsrl_tpu.envs import make as jmake
from fsrl_tpu.types import EpisodeStats as JStats
from fsrl_torch.algos.ppo_lag import PPOLag
from fsrl_torch.utils.params import to_jax_params

torch.set_num_threads(1)


def test_f32_update_on_point_goal_matches_jax():
    jenv = jmake("SafetyPointGoal1-v0")
    D, A = jenv.observation_size, jenv.action_size
    assert D == 21
    kw = dict(repeat=2, n_minibatches=2, cost_limit=5.0)
    jalgo = JPPOLag(D, A, gae_impl="scan", **kw)
    talgo = PPOLag(D, A, device="cpu", **kw)
    # the hand-derived gradient (K2's plain version on the CPU), not autograd
    assert talgo.use_grad_kernel
    jstate = jax.jit(jalgo.init)(jax.random.PRNGKey(0))
    tstate = talgo.init(state_dict=state_dict(jstate.params))
    T, N = 16, 32
    res = jax.jit(j_make_rollout(jenv, jalgo.act_fn, T))(
        jstate.params, jenv.reset_vec(jax.random.PRNGKey(1), N),
        JStats.init(N, 1), jax.random.PRNGKey(2))
    jtr = res.transitions
    assert float(np.asarray(jtr.cost).sum()) > 0     # hazards were hit
    ep_cost = np.array([7.0], np.float32)
    rng = jax.random.PRNGKey(5)
    jnew, jm = jax.jit(jalgo.update)(jstate, jtr, jnp.asarray(ep_cost),
                                     jnp.asarray(3, jnp.int32), rng)
    perms, roll, _ = _jax_perms(rng, T * N, 2, 2)
    tnew, tm = talgo.update(tstate, transition(jtr), t(ep_cost),
                            torch.tensor(3, dtype=torch.int32), None,
                            perms=(perms, roll))
    # as test_torch_ppo_lag.py::test_update_matches_jax: losses to f32
    # summation order, weights to 1e-5 after 4 Adam steps of lr 5e-4
    assert set(tm) == set(jm)
    for k in jm:
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-4,
                                             abs=1e-6), k
    jp = jax.tree.leaves(jax.device_get(jnew.params))
    tp = jax.tree.leaves(to_jax_params(tnew.params.state_dict()))
    worst = max(float(np.abs(a - np.asarray(b)).max()) for a, b in zip(tp, jp))
    assert worst < 1e-5, worst
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max()) for a, b
                in zip(jp, jax.tree.leaves(jax.device_get(jstate.params))))
    assert moved > 1e-4
    np.testing.assert_allclose(n(tnew.lag.multiplier),
                               np.asarray(jnew.lag.multiplier), rtol=1e-6,
                               atol=1e-7)
