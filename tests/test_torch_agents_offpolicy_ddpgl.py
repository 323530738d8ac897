"""DDPG-Lag learns with the constraint off: the torch twin of
``tests/test_all_agents.py::test_offpolicy_agent_learns_unconstrained``
(DDPGLagAgent), same task, budget, seed and threshold, on the CPU."""

from _torch_gates import learns_unconstrained

from fsrl_torch.agent import DDPGLagAgent


def test_ddpg_lag_learns_unconstrained():
    learns_unconstrained(DDPGLagAgent)
