"""Train TRPO-Lagrangian (port of ``examples/mlp/train_trpol_agent.py``).

    python -m fsrl_torch.examples.mlp.train_trpol_agent [--flag value ...]

Flags are the fields of :class:`fsrl_torch.config.configs.TRPOLagCfg`; see
:mod:`fsrl_torch.examples.mlp.common`.
"""

from fsrl_torch.agent import TRPOLagAgent
from fsrl_torch.config.cli import cli
from fsrl_torch.config.configs import TRPOLagCfg
from fsrl_torch.examples.mlp.common import run_train


@cli(TRPOLagCfg)
def main(cfg: TRPOLagCfg):
    return run_train(cfg, TRPOLagAgent, TRPOLagCfg())


if __name__ == "__main__":
    main()
