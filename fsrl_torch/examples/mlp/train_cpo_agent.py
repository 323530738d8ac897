"""Train CPO (port of ``examples/mlp/train_cpo_agent.py``).

    python -m fsrl_torch.examples.mlp.train_cpo_agent [--flag value ...]

Flags are the fields of :class:`fsrl_torch.config.configs.CPOCfg`; see
:mod:`fsrl_torch.examples.mlp.common`.
"""

from fsrl_torch.agent import CPOAgent
from fsrl_torch.config.cli import cli
from fsrl_torch.config.configs import CPOCfg
from fsrl_torch.examples.mlp.common import run_train


@cli(CPOCfg)
def main(cfg: CPOCfg):
    return run_train(cfg, CPOAgent, CPOCfg())


if __name__ == "__main__":
    main()
