"""Agents: algorithm factories with learn / evaluate."""

from fsrl_torch.agent.agents import (BaseAgent, CPOAgent, CVPOAgent,
                                     DDPGLagAgent, FOCOPSAgent, PPOLagAgent,
                                     RecurrentPPOLagAgent, SACLagAgent,
                                     TRPOLagAgent)

__all__ = ["BaseAgent", "CPOAgent", "CVPOAgent", "DDPGLagAgent",
           "FOCOPSAgent", "PPOLagAgent", "RecurrentPPOLagAgent", "SACLagAgent",
           "TRPOLagAgent"]
