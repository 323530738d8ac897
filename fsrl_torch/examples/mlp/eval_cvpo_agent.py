"""Evaluate a trained CVPO run directory (port of
``examples/mlp/eval_cvpo_agent.py``).

    python -m fsrl_torch.examples.mlp.eval_cvpo_agent --path <run directory>
"""

from fsrl_torch.agent import CVPOAgent
from fsrl_torch.examples.mlp.common import eval_main

if __name__ == "__main__":
    eval_main(CVPOAgent)
