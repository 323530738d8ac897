"""The learning gates of the port's trust-region and FOCOPS agents on the
CPU: torch twins of ``tests/test_all_agents.py``'s on-policy cases, with the
same task, budget and thresholds."""

import pytest
import torch

from fsrl_torch.agent import CPOAgent, FOCOPSAgent, TRPOLagAgent
from fsrl_torch.ops import kernels

torch.set_num_threads(1)

TASK = "SafetyBallRun-v0"

ONPOLICY = [
    (TRPOLagAgent, {"target_kl": 0.005}),
    (CPOAgent, {}),
    (FOCOPSAgent, {}),
]


@pytest.mark.parametrize("agent_cls,kw", ONPOLICY,
                         ids=[a.__name__ for a, _ in ONPOLICY])
def test_onpolicy_agent_learns_unconstrained(agent_cls, kw):
    kernels.reset_launch_counts()
    agent = agent_cls(TASK, cost_limit=9999.0, seed=0, device="cpu", **kw)
    assert agent.algo.hp["episode_len"] == agent.env.max_episode_steps
    info = agent.learn(epochs=8, step_per_epoch=5000, n_envs=10,
                       steps_per_collect=500, episode_per_test=4,
                       reward_threshold=300.0, verbose=False)
    assert info["best_reward"] > 300.0, f"{agent_cls.name}: {info}"
    rew, _, _ = agent.evaluate(n_episodes=4)
    assert rew > 250.0, f"{agent_cls.name} eval reward {rew}"
    # on the CPU the GAE wrapper ran its plain version
    assert sum(kernels.LAUNCHES.values()) == 0


def test_single_constraint_agents_take_no_num_costs():
    """CPO and FOCOPS are single-constraint; TRPO-Lag takes the env's M."""
    two = "SafetyBallCircle2C-v0"
    agent = TRPOLagAgent(two, cost_limit=[50.0, 100.0], seed=0, device="cpu")
    assert agent.algo.num_costs == 2 and agent.algo.K == 3
    info = agent.learn(epochs=1, step_per_epoch=2000, n_envs=8,
                       steps_per_collect=250, episode_per_test=2)
    assert info["epoch"] == 1
    assert agent.state.lag.multiplier.shape == (2,)
    for cls in (CPOAgent, FOCOPSAgent):
        assert cls.multi_constraint is False
        assert cls(TASK, seed=0, device="cpu").algo.K == 2


@pytest.mark.parametrize("agent_cls", [TRPOLagAgent, CPOAgent, FOCOPSAgent])
def test_agent_without_cuda_raises(agent_cls):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        agent_cls(TASK)
