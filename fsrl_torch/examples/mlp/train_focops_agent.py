"""Train FOCOPS (port of ``examples/mlp/train_focops_agent.py``).

    python -m fsrl_torch.examples.mlp.train_focops_agent [--flag value ...]

Flags are the fields of :class:`fsrl_torch.config.configs.FOCOPSCfg`; see
:mod:`fsrl_torch.examples.mlp.common`.
"""

from fsrl_torch.agent import FOCOPSAgent
from fsrl_torch.config.cli import cli
from fsrl_torch.config.configs import FOCOPSCfg
from fsrl_torch.examples.mlp.common import run_train


@cli(FOCOPSCfg)
def main(cfg: FOCOPSCfg):
    return run_train(cfg, FOCOPSAgent, FOCOPSCfg())


if __name__ == "__main__":
    main()
