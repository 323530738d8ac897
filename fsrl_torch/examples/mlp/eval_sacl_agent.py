"""Evaluate a trained SAC-Lagrangian run directory (port of
``examples/mlp/eval_sacl_agent.py``).

    python -m fsrl_torch.examples.mlp.eval_sacl_agent --path <run directory>
"""

from fsrl_torch.agent import SACLagAgent
from fsrl_torch.examples.mlp.common import eval_main

if __name__ == "__main__":
    eval_main(SACLagAgent)
