"""The port's ``HostOnpolicyTrainer`` against the JAX package's on the
deterministic stub env of ``_torch_host.py``, both acting with the mean
action from the same weights: the collected segment (and JAX's
``obs_next`` at a done step, which is the next episode's first
observation), the episodes' mean cost and count, then one PPO-Lag update
of that segment with JAX's minibatch permutations, and one whole epoch of
the port's loop."""

import jax
import numpy as np
import pytest
import torch
from _torch_host import A, D, EP, HUMANOID, stub_venvs
from _torch_parity import n, state_dict
from test_torch_ppo_lag import _jax_perms

from fsrl_torch.algos.ppo_lag import PPOLag
from fsrl_torch.algos.sac_lag import SACLag
from fsrl_torch.trainer.host_trainer import (HostOffpolicyTrainer,
                                             HostOnpolicyTrainer, host_copy)
from fsrl_torch.utils.logger import BaseLogger
from fsrl_torch.utils.params import to_jax_params
from fsrl_tpu.algos.ppo_lag import PPOLag as JPPOLag
from fsrl_tpu.trainer.host_trainer import \
    HostOnpolicyTrainer as JHostOnpolicyTrainer

torch.set_num_threads(1)

T, N = 12, 4
KW = dict(cost_limit=5.0, repeat=2, n_minibatches=2, episode_len=EP)


def _trainers(noise=None, d=D, a=A):
    """Both trainers from the same weights, acting with the mean action,
    or with the mean plus ``noise[t]`` at the t-th step (the same draws on
    both sides), on stub envs of widths ``d`` and ``a``."""
    jv, tv = stub_venvs(N, d, a)
    jalgo = JPPOLag(d, a, **KW)
    jtr = JHostOnpolicyTrainer(jalgo, jv, steps_per_collect=T, seed=0,
                               verbose=False)
    talgo = PPOLag(d, a, device="cpu", **KW)
    ttr = HostOnpolicyTrainer(talgo, tv, steps_per_collect=T, seed=0,
                              verbose=False)
    ttr.state = talgo.init(state_dict=state_dict(jtr.state.params))
    if noise is None:
        jtr.act_fn = jax.jit(jalgo.act_fn_eval)
        ttr.act_fn = talgo.act_fn_eval
        return jtr, ttr
    step = {"j": 0, "t": 0}

    def j_act(params, obs, rng):
        dist = jalgo.actor.apply(params["actor"], obs)
        act = dist.mode() + noise[step["j"]]
        step["j"] += 1
        return act, dist.log_prob(act)

    def t_act(params, obs, generator):
        dist = params.actor(obs)
        act = dist.mode() + torch.from_numpy(noise[step["t"]])
        step["t"] += 1
        return act, dist.log_prob(act)
    jtr.act_fn, ttr.act_fn = j_act, t_act
    return jtr, ttr


@pytest.fixture(scope="module")
def segments():
    jtr, ttr = _trainers()
    return jtr, ttr, jtr.collect_segment(), ttr.collect_segment()


def test_collect_segment_matches_jax(segments):
    _, _, (jtr_, jc, jn), (ttr_, tc, tn) = segments
    for name in ("obs", "obs_next", "reward", "cost", "terminated",
                 "truncated"):
        want, got = np.asarray(getattr(jtr_, name)), n(getattr(ttr_, name))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert n(ttr_.obs).shape == (T, N, D) and n(ttr_.cost).shape == (T, N, 1)
    # the actions and log-probs: the same mean action and its log-prob in
    # f32, computed by two libraries
    for name in ("act", "logp"):
        np.testing.assert_allclose(n(getattr(ttr_, name)),
                                   np.asarray(getattr(jtr_, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    assert int(tn) == int(jn) > 0
    np.testing.assert_array_equal(n(tc), np.asarray(jc))
    assert tc.shape == (1,) and tc.dtype == torch.float32


def test_obs_next_at_a_done_step_is_the_reset_observation(segments):
    """JAX's ``collect_segment`` writes the reset observation into the row
    that ``obs_next`` already holds; the port keeps that: at a truncation
    ``obs_next`` is the next episode's first observation (marker -1, step
    0), equal to the next step's ``obs``, not the episode's last one."""
    _, _, (jtr_, _, _), (ttr_, _, _) = segments
    for tr in (jtr_, ttr_):
        obs, obs_next = np.asarray(n(tr.obs)), np.asarray(n(tr.obs_next))
        trunc = np.asarray(n(tr.truncated))
        t, i = map(int, np.argwhere(trunc[:-1, :])[0])
        assert obs_next[t, i, 4] == -1.0 and obs_next[t, i, 1] == 0.0
        np.testing.assert_array_equal(obs_next[t, i], obs[t + 1, i])
        # a step that is not done: obs_next is the env's own next state
        assert obs_next[0, 0, 1] == 1.0 and obs_next[0, 0, 4] == 1.0


@pytest.mark.parametrize("d,a", [(D, A), HUMANOID],
                         ids=["stub", "humanoid"])
def test_update_on_a_segment_matches_jax(d, a):
    """One update of a segment that both trainers collect acting with the
    mean action plus the same draws, on the stub's widths and on
    Humanoid-v5's (348, 17), the widest of the velocity suite, where the
    port's update takes the fused gradient (its plain version on the CPU).
    (At the mean action itself the actor mean's gradient is rounding noise
    around 0, and Adam's first step moves every weight by about lr times
    its sign, which the two libraries draw differently.)"""
    noise = 0.3 * np.random.default_rng(4).normal(size=(T, N, a)).astype(
        np.float32)
    jtr, ttr = _trainers(noise, d, a)
    (jseg, jc, jn), (tseg, tc, tn) = jtr.collect_segment(), \
        ttr.collect_segment()
    np.testing.assert_allclose(n(tseg.act), np.asarray(jseg.act), atol=1e-6)
    np.testing.assert_allclose(n(tseg.logp), np.asarray(jseg.logp),
                               rtol=1e-6, atol=1e-6)
    rng = jax.random.PRNGKey(7)
    jnew, jm = jtr.update_fn(jtr.state, jseg, jc, jn, rng)
    perms, roll, _ = _jax_perms(rng, T * N, KW["repeat"],
                                KW["n_minibatches"])
    tnew, tm = ttr.algo.update(ttr.state, tseg, tc, tn, None,
                               perms=(perms, roll))
    assert ttr.algo.use_grad_kernel
    assert set(tm) == set(jm)
    for k in jm:
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-4,
                                             abs=1e-6), k
    # test_torch_ppo_lag.py's tolerance: 1e-5 after 4 Adam steps
    jp = jax.tree.leaves(jax.device_get(jnew.params))
    tp = jax.tree.leaves(to_jax_params(tnew.params.state_dict()))
    assert max(float(np.abs(a - np.asarray(b)).max())
               for a, b in zip(tp, jp)) < 1e-5


def test_epoch_runs_and_keeps_the_best_checkpoint(tmp_path):
    """One epoch of the port's loop: two collects and updates, the test
    collect (on the training envs, as in JAX), ``model_best.pt``."""
    _, tv = stub_venvs(N)
    algo = PPOLag(D, A, device="cpu", hidden_sizes=(16, 16), **KW)
    logger = BaseLogger(str(tmp_path), log_txt=False)
    tr = HostOnpolicyTrainer(algo, tv, logger=logger, epochs=1,
                             step_per_epoch=2 * T * N, steps_per_collect=T,
                             episode_per_test=3, seed=1, verbose=False)
    assert tr.test_venv is tr.venv
    info = tr.run()
    assert (info["epoch"], info["env_step"]) == (1, 2 * T * N)
    assert int(tr.state.update_count) == 2
    assert np.isfinite([info["test_reward"], info["test_cost"]]).all()
    assert all(np.isfinite(float(v)) for v in tr.last_metrics.values())
    assert (tmp_path / "checkpoint" / "model_best.pt").is_file()
    assert set(tr.collect_split) == {"env", "act", "transfer"}


def test_host_copy_is_an_independent_cpu_copy():
    algo = PPOLag(D, A, device="cpu", hidden_sizes=(16, 16))
    state = algo.init(0)
    cp = host_copy(state.params)
    for (k, a), (_, b) in zip(state.params.named_parameters(),
                              cp.named_parameters()):
        assert b.device.type == "cpu" and torch.equal(a, b), k
    state.flat.add_(1.0)
    assert not torch.equal(next(cp.parameters()),
                           next(state.params.parameters()))


def test_trainers_reject_the_other_family():
    _, tv = stub_venvs(2)
    with pytest.raises(TypeError, match="HostOffpolicyTrainer"):
        HostOnpolicyTrainer(SACLag(D, A, device="cpu"), tv)
    with pytest.raises(TypeError, match="HostOnpolicyTrainer"):
        HostOffpolicyTrainer(PPOLag(D, A, device="cpu"), tv)
