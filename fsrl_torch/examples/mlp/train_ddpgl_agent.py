"""Train DDPG-Lagrangian (port of ``examples/mlp/train_ddpgl_agent.py``).

    python -m fsrl_torch.examples.mlp.train_ddpgl_agent [--flag value ...]

Flags are the fields of :class:`fsrl_torch.config.configs.DDPGLagCfg`; see
:mod:`fsrl_torch.examples.mlp.common`.
"""

from fsrl_torch.agent import DDPGLagAgent
from fsrl_torch.config.cli import cli
from fsrl_torch.config.configs import DDPGLagCfg
from fsrl_torch.examples.mlp.common import run_train


@cli(DDPGLagCfg)
def main(cfg: DDPGLagCfg):
    return run_train(cfg, DDPGLagAgent, DDPGLagCfg())


if __name__ == "__main__":
    main()
