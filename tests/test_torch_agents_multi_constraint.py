"""PPO-Lag with two constraints end to end: the torch twin of
``tests/test_all_agents.py::test_ppo_lag_multi_constraint`` (vector costs,
a multiplier per constraint, rescaling over their sum), same task, budget
and seed, on the CPU."""

import torch

from fsrl_torch.agent import PPOLagAgent

torch.set_num_threads(1)


def test_ppo_lag_multi_constraint():
    agent = PPOLagAgent("SafetyBallCircle2C-v0", cost_limit=[50.0, 100.0],
                        seed=0, device="cpu")
    assert agent.algo.num_costs == 2
    info = agent.learn(epochs=2, step_per_epoch=4000, n_envs=8,
                       steps_per_collect=250, episode_per_test=4,
                       verbose=False)
    assert info["epoch"] == 2
    lam = agent.state.lag.multiplier
    assert lam.shape == (2,)
