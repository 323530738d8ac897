"""Agents: algorithm factories with learn / evaluate."""

from fsrl_torch.agent.agents import (BaseAgent, CPOAgent, FOCOPSAgent,
                                     PPOLagAgent, TRPOLagAgent)

__all__ = ["BaseAgent", "CPOAgent", "FOCOPSAgent", "PPOLagAgent",
           "TRPOLagAgent"]
