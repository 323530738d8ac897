"""Evaluate a run directory of ``train_ppol`` (port of
``examples/customized/eval_ppol.py``): reload config.yaml and the
checkpoint, rebuild the bare algorithm, run an episode-exact evaluation.

    python -m fsrl_torch.examples.customized.eval_ppol --path <run dir>
"""

from fsrl_torch.algos.ppo_lag import PPOLag
from fsrl_torch.examples.customized.custom_common import eval_main


def build(env, config, device):
    return PPOLag(env.observation_size, env.action_size,
                  cost_limit=config["cost_limit"],
                  repeat=config.get("repeat", 4),
                  n_minibatches=config.get("n_minibatches", 4),
                  lr=config.get("lr", 5e-4), device=device)


if __name__ == "__main__":
    eval_main(build)
