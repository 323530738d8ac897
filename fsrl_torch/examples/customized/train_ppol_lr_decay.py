"""Learning-rate scheduling with PPO-Lagrangian (port of
``examples/customized/train_ppol_lr_decay.py``).

The schedule is a plain function of the optimizer's gradient-step count,
evaluated on the device inside the update: no scheduler object, no
``.step()`` calls. This script trains PPO-Lag on SafetyBallCircle-v0 with
the linear decay to zero over the whole run, in *update* units (one unit a
``algo.update`` call, the reference's per-update ``LambdaLR`` cadence),
through :func:`fsrl_torch.algos.common.per_update_schedule`, and logs the
rate under ``train/lr``.

    python -m fsrl_torch.examples.customized.train_ppol_lr_decay \\
        --total_iters 200 [--device cpu]
"""

from dataclasses import dataclass

import torch

from fsrl_torch.algos.common import linear_schedule, per_update_schedule
from fsrl_torch.algos.ppo_lag import PPOLag
from fsrl_torch.config.cli import cli
from fsrl_torch.data.collector import evaluate, make_rollout_fn
from fsrl_torch.envs import make
from fsrl_torch.examples.mlp.common import run_logger
from fsrl_torch.types import EpisodeStats


@dataclass
class LRDecayCfg:
    task: str = "SafetyBallCircle-v0"
    cost_limit: float = 25.0
    lr: float = 5e-4
    total_iters: int = 200        # trainer updates over the whole run
    n_envs: int = 64
    steps_per_collect: int = 256
    repeat: int = 4
    n_minibatches: int = 4
    seed: int = 0
    logdir: str = "logs/ppol-lrdecay"
    eval_every: int = 50
    device: str = "cuda"


def make_schedule(cfg: LRDecayCfg):
    """``LambdaLR(lambda u: 1 - u / total_iters)``, in update units, as a
    function of the gradient-step count."""
    return per_update_schedule(
        linear_schedule(init_value=cfg.lr, end_value=0.0,
                        transition_steps=cfg.total_iters),
        grad_steps_per_update=cfg.repeat * cfg.n_minibatches)


@cli(LRDecayCfg)
def main(cfg: LRDecayCfg):
    """Train; returns the run directory and the final training state."""
    env = make(cfg.task)
    schedule = make_schedule(cfg)
    algo = PPOLag(env.observation_size, env.action_size,
                  cost_limit=cfg.cost_limit, lr=schedule,
                  repeat=cfg.repeat, n_minibatches=cfg.n_minibatches,
                  device=cfg.device)
    logger = run_logger(cfg.logdir, f"ppol-lrdecay-{cfg.task}")

    g = torch.Generator(device=algo.device).manual_seed(cfg.seed)
    state = algo.init(cfg.seed)
    env_state = env.reset_vec(cfg.n_envs, g)
    stats = EpisodeStats.init(cfg.n_envs, env.num_costs, algo.device)
    rollout = make_rollout_fn(env, algo.act_fn, cfg.steps_per_collect,
                              algo.device)

    for it in range(cfg.total_iters):
        res = rollout(state.params, env_state, stats.reset_aggregates(), g)
        state, _ = algo.update(state, res.transitions, res.stats.mean_cost,
                               res.stats.n_episodes, g)
        env_state, stats = res.env_state, res.stats
        lr_now = float(schedule(state.gradient_steps))
        if int(stats.n_episodes) > 0:
            logger.store(tab="train", reward=float(stats.mean_reward),
                         cost=float(stats.mean_cost.sum()), lr=lr_now)
        if (it + 1) % cfg.eval_every == 0:
            out = evaluate(env, algo.act_fn_eval, state.params, g, 10)
            logger.store(tab="test", reward=float(out["reward"]),
                         cost=float(out["cost"]))
            logger.write((it + 1) * cfg.steps_per_collect * cfg.n_envs)
    return logger.log_dir, state


if __name__ == "__main__":
    main()
