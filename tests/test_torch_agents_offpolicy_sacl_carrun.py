"""SAC-Lag holds a cost limit of 25 on SafetyCarRun-v0: the torch twin of
``tests/test_all_agents.py::test_offpolicy_agent_respects_constraint
[SACLagAgent-CarRun]``, same budget, seed and thresholds, on the CPU."""

from _torch_gates import respects_constraint

from fsrl_torch.agent import SACLagAgent


def test_sac_lag_respects_constraint_carrun():
    respects_constraint(SACLagAgent, "SafetyCarRun-v0")
