"""The off-policy agent gates of ``tests/test_all_agents.py`` (tasks,
budgets, seeds and thresholds unchanged), run on the port's agents on the
CPU. Each gate has a file of its own, so that ``--dist loadfile`` spreads
them over the workers."""

import torch

from fsrl_torch.ops import kernels

torch.set_num_threads(1)

TASK = "SafetyBallRun-v0"
LIMIT = 25.0


def learns_unconstrained(agent_cls) -> None:
    """``test_all_agents.py::test_offpolicy_agent_learns_unconstrained``."""
    kernels.reset_launch_counts()
    agent = agent_cls(TASK, cost_limit=9999.0, seed=0, device="cpu")
    info = agent.learn(
        epochs=6, step_per_epoch=3000, n_envs=4, steps_per_collect=100,
        episode_per_test=4, reward_threshold=100.0,
        buffer_size=50000, update_per_step=0.2, verbose=False)
    assert info["best_reward"] > 100.0, f"{agent_cls.name}: {info}"
    # the off-policy paths launch no kernel
    assert sum(kernels.LAUNCHES.values()) == 0


def respects_constraint(agent_cls, task: str) -> None:
    """``test_all_agents.py::test_offpolicy_agent_respects_constraint``:
    the feasibility-first best checkpoint has real reward within 1.2x the
    limit, and the final state holds the constraint by the final test or
    by the PID controller's EMA of the realized episodic cost."""
    agent = agent_cls(task, cost_limit=LIMIT, seed=0, device="cpu")
    info = agent.learn(
        epochs=8, step_per_epoch=5000, n_envs=4, steps_per_collect=100,
        episode_per_test=10, buffer_size=50000, update_per_step=0.2,
        verbose=False)
    assert info["best_reward"] > 80.0, f"{agent_cls.name}: {info}"
    assert info["best_cost"] <= 1.2 * LIMIT, (
        f"{agent_cls.name} infeasible best: {info}")
    ema = float(agent.state.lag.cost_ema.sum())
    assert info["test_cost"] <= 2.0 * LIMIT or ema <= 2.0 * LIMIT, (
        f"{agent_cls.name} final-state constraint divergence: "
        f"eval={info['test_cost']:.1f}, train-ema={ema:.1f}: {info}")
