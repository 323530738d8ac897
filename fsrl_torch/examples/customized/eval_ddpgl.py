"""Evaluate a run directory of ``train_ddpgl`` (port of
``examples/customized/eval_ddpgl.py``).

    python -m fsrl_torch.examples.customized.eval_ddpgl --path <run dir>
"""

from fsrl_torch.algos.ddpg_lag import DDPGLag
from fsrl_torch.examples.customized.custom_common import eval_main


def build(env, config, device):
    return DDPGLag(env.observation_size, env.action_size,
                   cost_limit=config["cost_limit"],
                   batch_size=config.get("batch_size", 256),
                   n_step=config.get("n_step", 3), device=device)


if __name__ == "__main__":
    eval_main(build)
