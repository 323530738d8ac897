"""Offline safe-RL dataset generation (port of
``examples/customized/collect_dataset.py``): train TRPO-Lagrangian while
sweeping the cost limit linearly from ``cost_start`` to ``cost_end`` over
the epochs, so that the collected trajectories cover the reward / cost
Pareto surface; store every rollout segment in a grid-filtered
:class:`fsrl_torch.data.traj_buf.TrajectoryBuffer` and export it as HDF5
(the D4RL / DSRL keys).

    python -m fsrl_torch.examples.customized.collect_dataset [--device cpu]

The rollouts run on the device; each segment goes to the host once, where
the buffer slices it into episodes. The limit is passed to the update at
run time (``TRPOLag.update(..., cost_limit=)``).
"""

from dataclasses import dataclass

import numpy as np
import torch

from fsrl_torch.algos.trpo_lag import TRPOLag
from fsrl_torch.config.cli import cli
from fsrl_torch.data.collector import make_rollout_fn
from fsrl_torch.data.traj_buf import TrajectoryBuffer
from fsrl_torch.envs import make
from fsrl_torch.types import EpisodeStats


@dataclass
class CollectCfg:
    task: str = "SafetyBallCircle-v0"
    cost_start: float = 10.0
    cost_end: float = 80.0
    epochs: int = 50
    iters_per_epoch: int = 4
    n_envs: int = 20
    steps_per_collect: int = 500
    max_trajectory: int = 2000
    rmin: float = -np.inf
    rmax: float = np.inf
    cmin: float = -np.inf
    cmax: float = np.inf
    seed: int = 0
    logdir: str = "logs/datasets"
    dataset_name: str = "dataset.hdf5"
    device: str = "cuda"


def cost_limit_at(cfg: CollectCfg, epoch: int) -> float:
    """The swept limit of ``epoch``: linear from ``cost_start`` at the first
    epoch to ``cost_end`` at the last."""
    frac = epoch / max(cfg.epochs - 1, 1)
    return cfg.cost_start + frac * (cfg.cost_end - cfg.cost_start)


@cli(CollectCfg)
def main(cfg: CollectCfg):
    """Collect and save; returns the dataset's path and the limits swept."""
    env = make(cfg.task)
    algo = TRPOLag(env.observation_size, env.action_size,
                   cost_limit=cfg.cost_start, target_kl=0.005,
                   device=cfg.device)
    g = torch.Generator(device=algo.device).manual_seed(cfg.seed)
    state = algo.init(cfg.seed)
    env_state = env.reset_vec(cfg.n_envs, g)
    stats = EpisodeStats.init(cfg.n_envs, env.num_costs, algo.device)
    rollout = make_rollout_fn(env, algo.act_fn, cfg.steps_per_collect,
                              algo.device)
    traj_buf = TrajectoryBuffer(max_trajectory=cfg.max_trajectory,
                                rmin=cfg.rmin, rmax=cfg.rmax,
                                cmin=cfg.cmin, cmax=cfg.cmax)

    limits = []
    for epoch in range(cfg.epochs):
        limit = cost_limit_at(cfg, epoch)
        limits.append(limit)
        limit_t = torch.tensor([limit], dtype=torch.float32,
                               device=algo.device)
        for _ in range(cfg.iters_per_epoch):
            res = rollout(state.params, env_state, stats.reset_aggregates(),
                          g)
            state, _ = algo.update(state, res.transitions,
                                   res.stats.mean_cost, res.stats.n_episodes,
                                   g, cost_limit=limit_t)
            env_state, stats = res.env_state, res.stats
            traj_buf.store_segment(res.transitions)
        print(f"epoch {epoch:3d} limit {limit:6.1f} "
              f"trajs {traj_buf.num_trajectories:5d} "
              f"transitions {len(traj_buf):8d}", flush=True)

    path = traj_buf.save(cfg.logdir, cfg.dataset_name)
    print(f"saved dataset to {path}")
    return path, limits


if __name__ == "__main__":
    main()
