"""Train PPO-Lagrangian (port of ``examples/mlp/train_ppol_agent.py``).

    python -m fsrl_torch.examples.mlp.train_ppol_agent [--flag value ...]

Flags are the fields of :class:`fsrl_torch.config.configs.PPOLagCfg`; see
:mod:`fsrl_torch.examples.mlp.common`.
"""

from fsrl_torch.agent import PPOLagAgent
from fsrl_torch.config.cli import cli
from fsrl_torch.config.configs import PPOLagCfg
from fsrl_torch.examples.mlp.common import run_train


@cli(PPOLagCfg)
def main(cfg: PPOLagCfg):
    return run_train(cfg, PPOLagAgent, PPOLagCfg())


if __name__ == "__main__":
    main()
