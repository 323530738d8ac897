"""Agents: algorithm factories with learn / evaluate."""

from fsrl_torch.agent.agents import BaseAgent, PPOLagAgent

__all__ = ["BaseAgent", "PPOLagAgent"]
