"""Evaluate a run directory of ``train_trpol`` (port of
``examples/customized/eval_trpol.py``).

    python -m fsrl_torch.examples.customized.eval_trpol --path <run dir>
"""

from fsrl_torch.algos.trpo_lag import TRPOLag
from fsrl_torch.examples.customized.custom_common import eval_main


def build(env, config, device):
    return TRPOLag(env.observation_size, env.action_size,
                   cost_limit=config["cost_limit"],
                   target_kl=config.get("target_kl", 0.001),
                   optim_critic_iters=config.get("optim_critic_iters", 20),
                   device=device)


if __name__ == "__main__":
    eval_main(build)
