"""Recurrent PPO-Lagrangian on the port against the JAX package: the GRU
cell's weight bridge, the recurrent rollout (hidden resets on done), the
replay property BPTT rests on, the carry across segments, and one update on
the same minibatch permutations."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (env_state, full_vec, n, rollout_transitions,
                           state_dict, t, transition)

from fsrl_tpu.algos.ppo_lag_rnn import RecurrentPPOLag as JRecurrentPPOLag
from fsrl_tpu.data.collector import make_rollout_fn as j_make_rollout
from fsrl_tpu.data.collector import map_action as j_map
from fsrl_tpu.envs import make as jmake
from fsrl_tpu.types import EpisodeStats as JStats
from fsrl_torch.algos.ppo_lag_rnn import RecurrentPPOLag
from fsrl_torch.data.collector import make_rollout_fn
from fsrl_torch.envs import make
from fsrl_torch.nets.mlp import GRUCell
from fsrl_torch.trainer.trainer import OnpolicyTrainer
from fsrl_torch.types import EpisodeStats
from fsrl_torch.utils.params import from_jax_params

torch.set_num_threads(1)

KW = dict(cost_limit=5.0, hidden_size=32, critic_hidden_sizes=(32, 32),
          repeat=2, n_minibatches=2)
# the actor's matmuls and the env's trig functions differ in the last bits
# between the libraries; trajectories integrate that over the steps
TOL = dict(rtol=1e-4, atol=1e-4)


def _pair(task, **kw):
    jenv = jmake(task)
    D, A, M = jenv.observation_size, jenv.action_size, jenv.num_costs
    jalgo = JRecurrentPPOLag(D, A, num_costs=M, **{**KW, **kw})
    params = jax.jit(jalgo.init)(jax.random.PRNGKey(3)).params
    talgo = RecurrentPPOLag(D, A, num_costs=M, device="cpu", **{**KW, **kw})
    tstate = talgo.init(state_dict=state_dict(params))
    return jenv, make(task), jalgo, params, talgo, tstate


def test_gru_cell_step_matches_flax():
    """One step of flax's GRUCell, of the port's cell on the bridged
    weights, and of torch.nn.GRUCell on the same weights stacked (r, z, n)
    with its r and z recurrent biases 0: float32 rounding apart (1e-6)."""
    D, H, B = 5, 16, 7
    cell = fnn.GRUCell(features=H)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, D)).astype(np.float32)
    h = rng.normal(size=(B, H)).astype(np.float32)
    params = cell.init(jax.random.PRNGKey(0), jnp.asarray(h), jnp.asarray(x))
    # non-zero biases, so that their placement is tested
    params = jax.tree.map(
        lambda a: a + 0.1 * rng.normal(size=a.shape).astype(np.float32)
        if a.ndim == 1 else a, jax.device_get(params))
    h_j, _ = cell.apply(params, jnp.asarray(h), jnp.asarray(x))
    sd = from_jax_params({"actor": {"params": {
        "GRUCell_0": params["params"]}}})
    port = GRUCell(D, H)
    port.load_state_dict({k[len("actor.cell."):]: v for k, v in sd.items()})
    xt, ht = torch.from_numpy(x), torch.from_numpy(h)
    np.testing.assert_allclose(n(port(xt, ht)), np.asarray(h_j), rtol=1e-6,
                               atol=1e-6)
    ref = torch.nn.GRUCell(D, H)
    with torch.no_grad():
        ref.weight_ih.copy_(sd["actor.cell.weight_ih"])
        ref.weight_hh.copy_(sd["actor.cell.weight_hh"])
        ref.bias_ih.copy_(sd["actor.cell.bias_ih"])
        ref.bias_hh.copy_(torch.cat([torch.zeros(2 * H),
                                     sd["actor.cell.bias_hn"]]))
    np.testing.assert_allclose(n(ref(xt, ht)), np.asarray(h_j), rtol=1e-6,
                               atol=1e-6)


def test_rollout_with_hidden_resets_matches_jax():
    """Deterministic actions from JAX's weights and initial states, JAX's
    auto-reset states handed to the port: the same transitions, log-probs
    and carries, with the hidden state zeroed where episodes end."""
    jenv, tenv, jalgo, params, talgo, tstate = _pair("SafetyCarCircle-v0")
    N, T = 16, 80       # staggered clocks: envs 14 and 15 truncate and reset
    js0 = jenv.reset_vec(jax.random.PRNGKey(1), N, stagger=True)
    rollout_j = jax.jit(j_make_rollout(jenv, jalgo.act_fn_eval, T,
                                       init_hidden=jalgo.init_hidden))
    res_j = rollout_j(params, js0, JStats.init(N, jenv.num_costs),
                      jax.random.PRNGKey(2))

    @jax.jit
    def step(state, h):
        act, _, h = jalgo.act_fn_eval(params, state.obs, h, None)
        a = j_map(act, jenv.action_low, jenv.action_high)
        fresh = jax.vmap(jenv.reset)(jenv.step_vec(state, a)[0].rng)
        state, ts = jenv.step_autoreset(state, a)
        return state, jnp.where(ts.done[:, None], 0.0, h), fresh

    fresh, s, h = [], js0, jalgo.init_hidden(N)
    for _ in range(T):
        s, h, f = step(s, h)
        fresh.append(env_state(f))
    res_t = make_rollout_fn(tenv, talgo.act_fn_eval, T, device="cpu",
                            init_hidden=talgo.init_hidden)(
        tstate.params, env_state(js0), EpisodeStats.init(N, tenv.num_costs),
        torch.Generator(), reset_states=fresh)
    tr_j, tr_t = res_j.transitions, res_t.transitions
    done = np.asarray(tr_j.done)
    assert done.sum() >= 2
    for name in ("obs", "act", "obs_next", "reward", "cost", "logp"):
        np.testing.assert_allclose(n(getattr(tr_t, name)),
                                   np.asarray(getattr(tr_j, name)),
                                   err_msg=name, **TOL)
    for name in ("terminated", "truncated"):
        np.testing.assert_array_equal(n(getattr(tr_t, name)),
                                      np.asarray(getattr(tr_j, name)))
    np.testing.assert_allclose(n(res_t.hidden), np.asarray(res_j.hidden),
                               **TOL)
    np.testing.assert_array_equal(n(res_t.init_hidden), 0.0)
    # an env whose episode ended at the last step starts the next segment
    # from a zero carry
    assert np.all(n(res_t.hidden)[done[-1]] == 0.0)


def test_bptt_replay_matches_collection_logp():
    """``tests/test_rnn_training.py``'s replay property on the port: the
    update's unroll from the segment's first carry, with the hidden state
    zeroed after every done step, gives the log-probs the rollout drew its
    actions with, across several auto-resets."""
    env = make("SafetyBallRun-v0")
    algo = RecurrentPPOLag(env.observation_size, env.action_size,
                           device="cpu", **KW)
    state = algo.init(0)
    T, N = env.max_episode_steps + 17, 4
    g = torch.Generator().manual_seed(7)
    rollout = make_rollout_fn(env, algo.act_fn, T, device="cpu",
                              init_hidden=algo.init_hidden)
    res = rollout(state.params, env.reset_vec(N, g),
                  EpisodeStats.init(N, env.num_costs), g)
    assert int(res.stats.n_episodes) >= 4
    tr = res.transitions
    names = state.params.actor_names()
    views = dict(zip(names, (dict(state.params.actor.named_parameters())[k]
                             for k in names)))
    with torch.no_grad():
        logp = algo.unroll(views, tr.obs, tr.terminated | tr.truncated,
                           res.init_hidden).log_prob(tr.act)
    np.testing.assert_allclose(n(logp), n(tr.logp), rtol=1e-5, atol=1e-5)


def test_cross_segment_hidden_carry():
    """The trainer carries the hidden state from one collect to the next,
    and the update gets the carry at the segment's start."""
    env = make("SafetyPointGoal1-v0")
    algo = RecurrentPPOLag(env.observation_size, env.action_size,
                           device="cpu", **KW)
    tr = OnpolicyTrainer(algo, env, n_envs=4, steps_per_collect=8,
                         episode_per_test=1, seed=0, verbose=False)
    seen, inner = [], tr.rollout
    tr.rollout = lambda *a, **k: seen.append(inner(*a, **k)) or seen[-1]
    updates, update = [], algo.update
    algo.update = lambda *a, **k: updates.append(a[2]) or update(*a, **k)
    tr._run_iter()
    tr._run_iter()
    r1, r2 = seen
    assert not torch.all(r1.hidden == 0)
    assert torch.equal(r2.init_hidden, r1.hidden)
    assert torch.equal(updates[1], r1.hidden)
    assert torch.equal(tr.hidden, r2.hidden)


def _jax_env_perms(rng, N, repeat, n_mb):
    """The per-epoch env permutations JAX's update draws from ``rng``."""
    per = N // n_mb
    return torch.from_numpy(np.stack([
        np.asarray(jax.random.permutation(k, N))[: n_mb * per]
        for k in jax.random.split(rng, repeat)])).long()


@pytest.mark.parametrize("case", ["one_cost", "two_costs", "early_stop"])
def test_update_matches_jax(case):
    """One update from the same weights, transitions, first carry and
    minibatch permutations. GAE runs through K1's plain version, which
    rounds where XLA fuses a multiply-add (as in test_torch_gae.py);
    with the libraries' f32 sums in other orders the gradients differ by
    ~1e-7 relative, and after 4 Adam steps of lr 5e-4 the weights agree
    to 1e-5 absolute, as in test_torch_ppo_lag.py."""
    kw = dict(two_costs=dict(num_costs=2, cost_limit=[5.0, 3.0]),
              early_stop=dict(target_kl=1e-7)).get(case, {})
    M = kw.get("num_costs", 1)
    T, N, D, A, H = 12, 8, 6, 2, 32
    jalgo = JRecurrentPPOLag(D, A, **{**KW, **kw})
    talgo = RecurrentPPOLag(D, A, device="cpu", **{**KW, **kw})
    jstate = jax.jit(jalgo.init)(jax.random.PRNGKey(0))
    tstate = talgo.init(state_dict=state_dict(jstate.params))
    jtr = rollout_transitions(T, N, D, A, M=M, seed=4)
    h0 = np.random.default_rng(5).normal(size=(N, H)).astype(np.float32)
    ep_cost = np.linspace(7.0, 2.0, M).astype(np.float32)
    rng = jax.random.PRNGKey(6)
    jnew, jm = jax.jit(jalgo.update)(jstate, jtr, jnp.asarray(h0),
                                     jnp.asarray(ep_cost),
                                     jnp.asarray(3, jnp.int32), rng)
    tnew, tm = talgo.update(tstate, transition(jtr), t(h0), t(ep_cost),
                            torch.tensor(3, dtype=torch.int32), None,
                            perms=_jax_env_perms(rng, N, 2, 2))
    assert set(tm) == set(jm)
    for k in jm:
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-4,
                                             abs=1e-6), k
    assert int(tnew.gradient_steps) == int(jnew.gradient_steps)
    if case == "early_stop":
        assert float(tm["update/early_stopped"]) == 1.0
        assert int(tnew.gradient_steps) == 2
    want = full_vec(tnew.params, jnew.params)
    assert float((tnew.flat - want).abs().max()) < 1e-5
    moved = float((want - full_vec(tnew.params, jstate.params)).abs().max())
    assert moved > 1e-4
    for name in ("multiplier", "cost_ema", "error_integral"):
        np.testing.assert_allclose(n(getattr(tnew.lag, name)),
                                   np.asarray(getattr(jnew.lag, name)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
