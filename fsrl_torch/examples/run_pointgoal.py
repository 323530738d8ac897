"""Real-physics PointGoal1 learning curves: train on the raw-MuJoCo
reconstruction (:mod:`fsrl_torch.envs.pointgoal_mj`) through the host path
(port of ``benchmarks/run_pointgoal.py``; the reference's navigation
suite, ``benchmark.rst:81-113``, at cost limit 25).

    python -m fsrl_torch.examples.run_pointgoal --algos ppol,cpo \\
        --seeds 0 --budget 1000000 [--device cpu]

Needs mujoco. Writes ``<outdir>/SafetyPointGoal1-MJ-v0-<algo>-s<seed>.json``
with the JAX runner's keys, skipping an (algo, seed) whose file exists,
then rewrites the directory's summary tables
(:func:`fsrl_torch.examples.make_summaries.summarize_dir`).

It differs from the JAX runner as :mod:`fsrl_torch.examples.run_velocity`
does: the default ``outdir`` is ``logs/results_pointgoal`` and
``benchmarks/`` is refused; an unknown algorithm key raises before any run
(the JAX runner raises when it reaches it); ``device`` picks where the
learner runs.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass

from fsrl_torch.config.cli import cli
from fsrl_torch.examples.make_summaries import summarize_dir
from fsrl_torch.examples.run_curves import results_dir

ALGOS = ("ppol", "trpol", "cpo")
TASK = "SafetyPointGoal1-MJ-v0"


@dataclass
class PGCfg:
    cost_limit: float = 25.0
    budget: int = 1000000
    step_per_epoch: int = 20000
    n_envs: int = 10
    steps_per_collect: int = 2000    # 20k-step collects (MujocoBaseCfg)
    episode_per_test: int = 4
    algos: str = "ppol,cpo"
    seeds: str = "0"
    outdir: str = "logs/results_pointgoal"
    pid: str = "0.05,0.0005,0.1"
    device: str = "cuda"


def run_one(cfg: PGCfg, key: str, seed: int) -> dict:
    """Train one (algo, seed) at the budget and return its result row."""
    from fsrl_torch.algos.cpo import CPO
    from fsrl_torch.algos.ppo_lag import PPOLag
    from fsrl_torch.algos.trpo_lag import TRPOLag
    from fsrl_torch.envs.pointgoal_mj import make_pointgoal_vector_env
    from fsrl_torch.trainer.host_trainer import HostOnpolicyTrainer

    venv = make_pointgoal_vector_env(n_envs=cfg.n_envs)
    epochs = max(1, cfg.budget // cfg.step_per_epoch)
    nmb = max(1, (cfg.steps_per_collect * cfg.n_envs) // 256)
    gains = tuple(float(g) for g in cfg.pid.split(","))
    dims = (venv.observation_size, venv.action_size)
    common = dict(cost_limit=cfg.cost_limit, episode_len=1000,
                  device=cfg.device)
    if key == "ppol":
        algo = PPOLag(*dims, lagrangian_pid=gains, repeat=4,
                      n_minibatches=nmb, **common)
    elif key == "trpol":
        algo = TRPOLag(*dims, lagrangian_pid=gains, **common)
    else:
        algo = CPO(*dims, **common)
    trainer = HostOnpolicyTrainer(
        algo, venv, epochs=epochs, step_per_epoch=cfg.step_per_epoch,
        steps_per_collect=cfg.steps_per_collect,
        episode_per_test=cfg.episode_per_test,
        cost_limit=cfg.cost_limit, seed=seed, verbose=False)

    curve = {"env_step": [], "reward": [], "cost": []}
    t0 = time.time()
    for epoch, _, info in trainer:
        curve["env_step"].append(info["env_step"])
        curve["reward"].append(info["test_reward"])
        curve["cost"].append(info["test_cost"])
        print(f"  epoch {epoch}/{epochs} step {info['env_step']} "
              f"rew {info['test_reward']:.1f} cost {info['test_cost']:.1f} "
              f"({info['speed']:,.0f} st/s)", flush=True)
    wall = time.time() - t0
    venv.close()
    return {
        "algo": key, "task": TASK, "seed": seed, "physics": "mujoco",
        "cost_limit": cfg.cost_limit, "budget": cfg.budget, "wall_s": wall,
        "steps_per_s": cfg.budget / wall,
        "final_reward": curve["reward"][-1], "final_cost": curve["cost"][-1],
        "best_reward": float(trainer.best_rew),
        "best_cost": float(trainer.best_cost),
        "curve": curve,
    }


@cli(PGCfg)
def main(cfg: PGCfg) -> list[dict]:
    keys = cfg.algos.split(",")
    unknown = [k for k in keys if k not in ALGOS]
    if unknown:
        raise KeyError(f"unknown algos {unknown}; known: {list(ALGOS)}")
    out = results_dir(cfg.outdir)
    rows = []
    for key in keys:
        for seed in (int(s) for s in cfg.seeds.split(",")):
            path = os.path.join(out, f"{TASK}-{key}-s{seed}.json")
            if os.path.exists(path):
                print(f"skip {key}/s{seed}")
                continue
            print(f"=== {key} seed {seed} PointGoal1-MJ ===", flush=True)
            res = run_one(cfg, key, seed)
            with open(path, "w") as f:
                json.dump(res, f)
            rows.append(res)
            print(f"    best {res['best_reward']:.1f} @ cost "
                  f"{res['best_cost']:.1f}  ({res['wall_s']:.0f}s)",
                  flush=True)
    summarize_dir(str(out))
    return rows


if __name__ == "__main__":
    main()
