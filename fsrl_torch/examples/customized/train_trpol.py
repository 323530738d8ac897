"""A TRPO-Lagrangian training loop assembled by hand (port of
``examples/customized/train_trpol.py``): a natural-gradient update on the
whole fresh on-policy segment, the PID multiplier fed by the episodic
cost; no agent, no trainer.

    python -m fsrl_torch.examples.customized.train_trpol [--device cpu]

On CUDA the update runs the GAE kernel.
"""

from dataclasses import dataclass

import torch

from fsrl_torch.algos.trpo_lag import TRPOLag
from fsrl_torch.config.cli import cli
from fsrl_torch.data.collector import evaluate, make_rollout_fn
from fsrl_torch.envs import make
from fsrl_torch.examples.customized.custom_common import save_model, setup_run
from fsrl_torch.types import EpisodeStats


@dataclass
class CustomCfg:
    task: str = "SafetyBallCircle-v0"
    cost_limit: float = 25.0
    total_iters: int = 100
    n_envs: int = 32
    steps_per_collect: int = 300
    target_kl: float = 0.005
    optim_critic_iters: int = 20
    seed: int = 0
    logdir: str = "logs/custom"
    eval_every: int = 20
    device: str = "cuda"


@cli(CustomCfg)
def main(cfg: CustomCfg):
    """Train; returns the run directory and the final training state."""
    env = make(cfg.task)
    algo = TRPOLag(env.observation_size, env.action_size,
                   cost_limit=cfg.cost_limit, target_kl=cfg.target_kl,
                   optim_critic_iters=cfg.optim_critic_iters,
                   device=cfg.device)
    logger = setup_run(cfg, "trpol_custom")

    g = torch.Generator(device=algo.device).manual_seed(cfg.seed)
    state = algo.init(cfg.seed)
    env_state = env.reset_vec(cfg.n_envs, g)
    stats = EpisodeStats.init(cfg.n_envs, env.num_costs, algo.device)
    rollout = make_rollout_fn(env, algo.act_fn, cfg.steps_per_collect,
                              algo.device)

    for it in range(cfg.total_iters):
        res = rollout(state.params, env_state, stats.reset_aggregates(), g)
        state, m = algo.update(state, res.transitions, res.stats.mean_cost,
                               res.stats.n_episodes, g)
        env_state, stats = res.env_state, res.stats
        if int(stats.n_episodes) > 0:
            logger.store(tab="train", reward=float(stats.mean_reward),
                         cost=float(stats.mean_cost.sum()))
        if (it + 1) % cfg.eval_every == 0:
            out = evaluate(env, algo.act_fn_eval, state.params, g, 10)
            logger.store(tab="test", reward=float(out["reward"]),
                         cost=float(out["cost"]),
                         kl=float(m["update/kl"]) if "update/kl" in m
                         else 0.0)
            logger.write((it + 1) * cfg.steps_per_collect * cfg.n_envs)
    save_model(logger, state)
    logger.print(f"run dir: {logger.log_dir}")
    return logger.log_dir, state


if __name__ == "__main__":
    main()
