"""A DDPG-Lagrangian training loop assembled by hand (port of
``examples/customized/train_ddpgl.py``): a ring replay buffer on the
device, the PID multiplier stepped once per collect on the fresh collect's
episodic cost, n-step target updates sampled from replay; no agent, no
trainer.

    python -m fsrl_torch.examples.customized.train_ddpgl [--device cpu]
"""

from dataclasses import dataclass

import torch

from fsrl_torch.algos.ddpg_lag import DDPGLag
from fsrl_torch.algos.offpolicy_base import make_nstep_view
from fsrl_torch.config.cli import cli
from fsrl_torch.data.buffer import ReplayBuffer
from fsrl_torch.data.collector import evaluate, make_rollout_fn
from fsrl_torch.envs import make
from fsrl_torch.examples.customized.custom_common import save_model, setup_run
from fsrl_torch.types import EpisodeStats


@dataclass
class CustomCfg:
    task: str = "SafetyBallRun-v0"
    cost_limit: float = 25.0
    total_iters: int = 300
    n_envs: int = 8
    steps_per_collect: int = 100
    updates_per_collect: int = 160   # update_per_step=0.2 x 800 steps
    buffer_size: int = 200000
    batch_size: int = 256
    n_step: int = 3
    seed: int = 0
    logdir: str = "logs/custom"
    eval_every: int = 50
    device: str = "cuda"


@cli(CustomCfg)
def main(cfg: CustomCfg):
    """Train; returns the run directory and the final training state."""
    env = make(cfg.task)
    algo = DDPGLag(env.observation_size, env.action_size,
                   cost_limit=cfg.cost_limit, batch_size=cfg.batch_size,
                   n_step=cfg.n_step, device=cfg.device)
    buffer = ReplayBuffer(cfg.buffer_size // cfg.n_envs, cfg.n_envs,
                          algo.device)
    logger = setup_run(cfg, "ddpgl_custom")

    g = torch.Generator(device=algo.device).manual_seed(cfg.seed)
    state = algo.init(cfg.seed)
    env_state = env.reset_vec(cfg.n_envs, g)
    stats = EpisodeStats.init(cfg.n_envs, env.num_costs, algo.device)
    buf_state = buffer.init(env.observation_size, env.action_size,
                            env.num_costs)
    rollout = make_rollout_fn(env, algo.act_fn, cfg.steps_per_collect,
                              algo.device)

    for it in range(cfg.total_iters):
        res = rollout(state.params, env_state, stats.reset_aggregates(), g)
        buf_state = buffer.add_segment(buf_state, res.transitions)
        state = algo.update_lagrangian(state, res.stats.mean_cost,
                                       res.stats.n_episodes)
        view = make_nstep_view(buffer, buf_state)
        for _ in range(cfg.updates_per_collect):
            state, _ = algo.update_step(state, buffer, buf_state, g,
                                        view=view)
        env_state, stats = res.env_state, res.stats
        if int(stats.n_episodes) > 0:
            logger.store(tab="train", reward=float(stats.mean_reward),
                         cost=float(stats.mean_cost.sum()))
        if (it + 1) % cfg.eval_every == 0:
            out = evaluate(env, algo.act_fn_eval, state.params, g, 10)
            logger.store(tab="test", reward=float(out["reward"]),
                         cost=float(out["cost"]))
            logger.write((it + 1) * cfg.steps_per_collect * cfg.n_envs)
    save_model(logger, state)
    logger.print(f"run dir: {logger.log_dir}")
    return logger.log_dir, state


if __name__ == "__main__":
    main()
