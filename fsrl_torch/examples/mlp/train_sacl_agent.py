"""Train SAC-Lagrangian (port of ``examples/mlp/train_sacl_agent.py``).

    python -m fsrl_torch.examples.mlp.train_sacl_agent [--flag value ...]

Flags are the fields of :class:`fsrl_torch.config.configs.SACLagCfg`; see
:mod:`fsrl_torch.examples.mlp.common`.
"""

from fsrl_torch.agent import SACLagAgent
from fsrl_torch.config.cli import cli
from fsrl_torch.config.configs import SACLagCfg
from fsrl_torch.examples.mlp.common import run_train


@cli(SACLagCfg)
def main(cfg: SACLagCfg):
    return run_train(cfg, SACLagAgent, SACLagCfg())


if __name__ == "__main__":
    main()
