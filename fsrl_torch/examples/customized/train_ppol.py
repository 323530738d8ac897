"""A PPO-Lagrangian training loop assembled by hand (port of
``examples/customized/train_ppol.py``): build the algorithm, write your own
collect-then-update iteration, own the logging and checkpoint cadence; no
agent, no trainer.

    python -m fsrl_torch.examples.customized.train_ppol [--device cpu]

On CUDA the update runs the GAE kernel and the fused PPO-Lag gradient
kernel.
"""

from dataclasses import dataclass

import torch

from fsrl_torch.algos.ppo_lag import PPOLag
from fsrl_torch.config.cli import cli
from fsrl_torch.data.collector import evaluate, make_rollout_fn
from fsrl_torch.envs import make
from fsrl_torch.examples.customized.custom_common import save_model, setup_run
from fsrl_torch.types import EpisodeStats


@dataclass
class CustomCfg:
    task: str = "SafetyCarCircle-v0"
    cost_limit: float = 10.0
    total_iters: int = 200
    n_envs: int = 32
    steps_per_collect: int = 300
    repeat: int = 4
    n_minibatches: int = 4
    lr: float = 5e-4
    seed: int = 0
    logdir: str = "logs/custom"
    eval_every: int = 20
    device: str = "cuda"


@cli(CustomCfg)
def main(cfg: CustomCfg):
    """Train; returns the run directory and the final training state."""
    env = make(cfg.task)
    algo = PPOLag(env.observation_size, env.action_size,
                  cost_limit=cfg.cost_limit, lr=cfg.lr, repeat=cfg.repeat,
                  n_minibatches=cfg.n_minibatches, device=cfg.device)
    logger = setup_run(cfg, "ppol_custom")

    # every draw (reset states, actions, minibatch permutations, tests)
    # comes from one generator seeded from the config
    g = torch.Generator(device=algo.device).manual_seed(cfg.seed)
    state = algo.init(cfg.seed)
    env_state = env.reset_vec(cfg.n_envs, g)
    stats = EpisodeStats.init(cfg.n_envs, env.num_costs, algo.device)
    rollout = make_rollout_fn(env, algo.act_fn, cfg.steps_per_collect,
                              algo.device)

    best = -float("inf")
    for it in range(cfg.total_iters):
        res = rollout(state.params, env_state, stats.reset_aggregates(), g)
        # on-policy: the PID multiplier is fed by this collect's episodic
        # cost, then the whole fresh segment is the update batch
        state, _ = algo.update(state, res.transitions, res.stats.mean_cost,
                               res.stats.n_episodes, g)
        env_state, stats = res.env_state, res.stats
        if int(stats.n_episodes) > 0:
            logger.store(tab="train", reward=float(stats.mean_reward),
                         cost=float(stats.mean_cost.sum()))
        if (it + 1) % cfg.eval_every == 0:
            out = evaluate(env, algo.act_fn_eval, state.params, g, 10)
            rew, cost = float(out["reward"]), float(out["cost"])
            logger.store(tab="test", reward=rew, cost=cost)
            logger.write((it + 1) * cfg.steps_per_collect * cfg.n_envs)
            # the feasibility-first best rule, by hand
            if cost <= cfg.cost_limit and rew > best:
                best = rew
                save_model(logger, state, best=True)
    save_model(logger, state)
    logger.print(f"run dir: {logger.log_dir}")
    return logger.log_dir, state


if __name__ == "__main__":
    main()
