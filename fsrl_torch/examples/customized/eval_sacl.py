"""Evaluate a run directory of ``train_sac_custom`` (port of
``examples/customized/eval_sacl.py``).

    python -m fsrl_torch.examples.customized.eval_sacl --path <run dir>
"""

from fsrl_torch.algos.sac_lag import SACLag
from fsrl_torch.examples.customized.custom_common import eval_main


def build(env, config, device):
    return SACLag(env.observation_size, env.action_size,
                  cost_limit=config["cost_limit"],
                  batch_size=config.get("batch_size", 256), device=device)


if __name__ == "__main__":
    eval_main(build)
