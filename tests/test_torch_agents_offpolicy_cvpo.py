"""CVPO learns with the constraint off: the torch twin of
``tests/test_all_agents.py::test_offpolicy_agent_learns_unconstrained``
(CVPOAgent), same task, budget, seed and threshold, on the CPU. (The
constrained CVPO gate takes about six minutes on the CPU; it runs on the
card, in ``chip_smoke.py``'s ``[gates offpolicy]`` phase.)"""

from _torch_gates import learns_unconstrained

from fsrl_torch.agent import CVPOAgent


def test_cvpo_learns_unconstrained():
    learns_unconstrained(CVPOAgent)
