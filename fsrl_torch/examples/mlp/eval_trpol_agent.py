"""Evaluate a trained TRPO-Lagrangian run directory (port of
``examples/mlp/eval_trpol_agent.py``).

    python -m fsrl_torch.examples.mlp.eval_trpol_agent --path <run directory>
"""

from fsrl_torch.agent import TRPOLagAgent
from fsrl_torch.examples.mlp.common import eval_main

if __name__ == "__main__":
    eval_main(TRPOLagAgent)
