"""Train CVPO (port of ``examples/mlp/train_cvpo_agent.py``).

    python -m fsrl_torch.examples.mlp.train_cvpo_agent [--flag value ...]

Flags are the fields of :class:`fsrl_torch.config.configs.CVPOCfg`; see
:mod:`fsrl_torch.examples.mlp.common`.
"""

from fsrl_torch.agent import CVPOAgent
from fsrl_torch.config.cli import cli
from fsrl_torch.config.configs import CVPOCfg
from fsrl_torch.examples.mlp.common import run_train


@cli(CVPOCfg)
def main(cfg: CVPOCfg):
    return run_train(cfg, CVPOAgent, CVPOCfg())


if __name__ == "__main__":
    main()
