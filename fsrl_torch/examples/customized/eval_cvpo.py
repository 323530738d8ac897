"""Evaluate a run directory of ``train_cvpo`` (port of
``examples/customized/eval_cvpo.py``).

    python -m fsrl_torch.examples.customized.eval_cvpo --path <run dir>
"""

from fsrl_torch.algos.cvpo import CVPO
from fsrl_torch.examples.customized.custom_common import eval_main


def build(env, config, device):
    return CVPO(env.observation_size, env.action_size,
                cost_limit=config["cost_limit"],
                max_episode_steps=env.max_episode_steps,
                batch_size=config.get("batch_size", 256),
                sample_act_num=config.get("sample_act_num", 16),
                device=device)


if __name__ == "__main__":
    eval_main(build)
