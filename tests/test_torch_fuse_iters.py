"""The port's ``fuse_iters`` and ``rollout_unroll`` on the CPU, the twin of
``tests/test_fuse_iters.py``: k collect-and-update cycles a dispatch are
the k sequential dispatches (the same generator stream, the PID stepped
each cycle, the same parameters bit for bit), an epoch counts JAX's
``T * n_envs * fuse_iters`` env steps a dispatch, the train metrics come
once a dispatch, and a recurrent carry crosses the cycles. ``rollout_unroll``
changes no rollout. On the card the same settings replay CUDA graphs
(``chip_smoke.py``'s ``[graph ...]`` phases hold them to these eager
cycles); here they run eagerly."""

import pytest
import torch

from fsrl_torch.agent import PPOLagAgent, RecurrentPPOLagAgent
from fsrl_torch.data.collector import make_rollout_fn
from fsrl_torch.trainer import OnpolicyTrainer
from fsrl_torch.types import EpisodeStats
from fsrl_tpu.trainer.trainer import OnpolicyTrainerTPU

torch.set_num_threads(1)


def build(fuse, unroll=1, agent_cls=PPOLagAgent, task="SafetyBallRun-v0"):
    """``tests/test_fuse_iters.py``'s configuration: BallRun, 4 envs x 16
    steps, repeat 2 x 2 minibatches, one epoch of 128 steps."""
    kw = dict(repeat=2, n_minibatches=2) if agent_cls is PPOLagAgent else {}
    agent = agent_cls(task, cost_limit=10.0, seed=0, device="cpu", **kw)
    return OnpolicyTrainer(
        agent.algo, agent.env, None, cost_limit=10.0, seed=0, n_envs=4,
        steps_per_collect=16, epochs=1, step_per_epoch=128,
        episode_per_test=2, verbose=False, log_every=1, fuse_iters=fuse,
        rollout_unroll=unroll, state=agent.state)


def _equal(a, b):
    return torch.equal(a.state.flat, b.state.flat) and torch.equal(
        a.env_state.obs, b.env_state.obs) and all(
        torch.equal(x, y) for x, y in zip(a.env_state.sim.values(),
                                          b.env_state.sim.values()))


def test_fused_matches_sequential():
    t1, t2 = build(1), build(2)
    # one epoch = 128 steps = 2 cycles of 4 envs x 16 steps: one fused
    # dispatch, two sequential ones
    next(iter(t1))
    next(iter(t2))
    assert t1.env_step == t2.env_step == 128
    assert _equal(t1, t2)
    assert torch.equal(t1.state.lag.multiplier, t2.state.lag.multiplier)
    assert int(t1.state.update_count) == int(t2.state.update_count) == 2
    # one train log row a dispatch
    assert (t1._iter_count, t2._iter_count) == (2, 1)
    # the test between epochs continues the same generator stream
    assert torch.equal(t1.generator.get_state(), t2.generator.get_state())
    assert t1.dispatch_mode == "eager"
    assert t2.dispatch_mode == "eager (on the CPU)"


def test_step_accounting_is_jax():
    """JAX's trainer counts the same env steps an epoch at both
    settings."""
    from fsrl_tpu.algos.ppo_lag import PPOLag as JPPOLag
    from fsrl_tpu.envs import make as jmake
    env = jmake("SafetyBallRun-v0")
    for fuse in (1, 2):
        jt = OnpolicyTrainerTPU(
            JPPOLag(env.observation_size, env.action_size, cost_limit=10.0,
                    repeat=2, n_minibatches=2), env, None, n_envs=4,
            steps_per_collect=16, epochs=1, step_per_epoch=128,
            fuse_iters=fuse, verbose=False)
        tr = build(fuse)
        assert (tr.fuse_iters, tr.T * tr.n_envs * tr.fuse_iters) == (
            jt.fuse_iters, jt.T * jt.n_envs * jt.fuse_iters)
    assert build(0).fuse_iters == 1 and build(1, unroll=-3).rollout_unroll \
        == 1


def test_recurrent_carry_crosses_the_cycles():
    t1 = build(1, agent_cls=RecurrentPPOLagAgent, task="SafetyPointGoal1-v0")
    t2 = build(2, agent_cls=RecurrentPPOLagAgent, task="SafetyPointGoal1-v0")
    for _ in range(2):
        t1._run_iter()
    t2._run_iter()
    assert _equal(t1, t2)
    assert torch.equal(t1.hidden, t2.hidden)


@pytest.mark.parametrize("unroll", [4, 5])
def test_rollout_unroll_changes_no_rollout(unroll):
    """A rollout built with ``unroll`` equals the plain one, and so does a
    trainer's epoch (16 steps: 4 of 4, or 3 of 5 and a remainder on the
    card)."""
    agent = PPOLagAgent("SafetyBallRun-v0", cost_limit=10.0, seed=0,
                        device="cpu")
    env, algo = agent.env, agent.algo
    outs = []
    for u in (1, unroll):
        g = torch.Generator().manual_seed(3)
        state = env.reset_vec(4, g, stagger=True)
        roll = make_rollout_fn(env, algo.act_fn, 16, "cpu", unroll=u)
        outs.append(roll(agent.state.params, state,
                         EpisodeStats.init(4, env.num_costs), g))
    for name in vars(outs[0].transitions):
        assert torch.equal(getattr(outs[0].transitions, name),
                           getattr(outs[1].transitions, name))
    assert torch.equal(outs[0].env_state.obs, outs[1].env_state.obs)
    assert torch.equal(outs[0].stats.sum_reward, outs[1].stats.sum_reward)
    t1, t2 = build(1), build(1, unroll=unroll)
    next(iter(t1))
    next(iter(t2))
    assert _equal(t1, t2)


def test_agents_pass_the_settings_to_their_trainers():
    """``learn``'s trainer keywords reach the trainers, as the JAX agents'
    do (``fsrl_tpu/agent/agents.py:86``)."""
    from fsrl_torch.agent import SACLagAgent
    on = PPOLagAgent("SafetyBallRun-v0", cost_limit=10.0, device="cpu",
                     repeat=1, n_minibatches=1)
    on.learn(epochs=1, step_per_epoch=64, n_envs=2, steps_per_collect=16,
             episode_per_test=1, fuse_iters=2, rollout_unroll=4)
    assert (on.trainer.fuse_iters, on.trainer.rollout_unroll) == (2, 4)
    assert on.trainer.env_step == 64 and on.trainer._iter_count == 1
    off = SACLagAgent("SafetyBallRun-v0", cost_limit=10.0, device="cpu",
                      batch_size=16)
    off.learn(epochs=1, step_per_epoch=64, n_envs=2, steps_per_collect=16,
              episode_per_test=1, buffer_size=200, update_per_step=0.25,
              update_chunk=3, fuse_iters=2)
    assert (off.trainer.fuse_iters, off.trainer.chunk_sizes) == (2, [3, 3, 2])
    assert int(off.state.gradient_steps) == 16
