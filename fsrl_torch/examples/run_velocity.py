"""Real-physics learning curves: train on the Safety-Gymnasium velocity
tasks through the host path (true MuJoCo dynamics stepped on the host, the
learner on the device) and record each epoch's test reward and cost (port
of ``benchmarks/run_velocity.py``, the reference's velocity-suite
protocol, ``docs/tutorials/benchmark.rst:47-78``: 5 tasks, cost limit 25).

    python -m fsrl_torch.examples.run_velocity \\
        --task SafetyHalfCheetahVelocity-v1 --algos ppol,sacl \\
        --budget 1000000 --seeds 0 [--device cpu]

Needs gymnasium and mujoco. Writes one JSON per (algo, seed),
``<outdir>/<task>-<algo>[-pid<kp_ki_kd>]-s<seed>.json`` with the JAX
runner's keys (the ``-pid`` tag for ppol and trpol run at other than the
default gains), then rewrites the directory's summary tables
(:func:`fsrl_torch.examples.make_summaries.summarize_dir`).

It differs from the JAX runner in three ways:

* the default ``outdir`` is ``logs/results_velocity`` (git ignores
  ``logs/``), and a run refuses to write into the repository's
  ``benchmarks/``;
* an algorithm key it does not know raises before any run (the JAX runner
  trains CVPO for any key it does not name, ``run_velocity.py:104``);
* ``device`` picks where the learner runs (the card by default).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass

from fsrl_torch.config.cli import cli
from fsrl_torch.examples.make_summaries import summarize_dir
from fsrl_torch.examples.run_curves import results_dir

ONPOLICY = ("ppol", "trpol", "cpo", "focops")
OFFPOLICY = ("sacl", "ddpgl", "cvpo")
DEFAULT_PID = "0.05,0.0005,0.1"


@dataclass
class VelCurveCfg:
    task: str = "SafetyHalfCheetahVelocity-v1"
    cost_limit: float = 25.0
    budget: int = 1000000           # on-policy env-step budget
    off_budget: int = 300000        # off-policy env-step budget
    step_per_epoch: int = 20000
    n_envs: int = 10
    # 2000 host steps x 10 envs = one 20k-step collect, the reference's
    # MujocoBaseCfg protocol (20 episodes of 1000 steps a collect)
    steps_per_collect: int = 2000
    off_n_envs: int = 4
    off_steps_per_collect: int = 100
    episode_per_test: int = 4
    algos: str = "ppol,sacl"
    seeds: str = "0"
    outdir: str = "logs/results_velocity"
    # PID gains of the on-policy run: velocity episodes are 1000 steps with
    # costs about 10x the Bullet analogs'
    pid: str = DEFAULT_PID
    device: str = "cuda"


def run_one(cfg: VelCurveCfg, key: str, seed: int) -> dict:
    """Train one (algo, seed) at the budget and return its result row."""
    from fsrl_torch.algos.cpo import CPO
    from fsrl_torch.algos.cvpo import CVPO
    from fsrl_torch.algos.ddpg_lag import DDPGLag
    from fsrl_torch.algos.focops import FOCOPS
    from fsrl_torch.algos.ppo_lag import PPOLag
    from fsrl_torch.algos.sac_lag import SACLag
    from fsrl_torch.algos.trpo_lag import TRPOLag
    from fsrl_torch.envs.velocity import make_velocity_vector_env
    from fsrl_torch.trainer.host_trainer import (HostOffpolicyTrainer,
                                                 HostOnpolicyTrainer)

    onpolicy = key in ONPOLICY
    budget = cfg.budget if onpolicy else cfg.off_budget
    n_envs = cfg.n_envs if onpolicy else cfg.off_n_envs
    venv = make_velocity_vector_env(cfg.task, n_envs=n_envs)
    epochs = max(1, budget // cfg.step_per_epoch)
    dims = (venv.observation_size, venv.action_size)
    t0 = time.time()
    if onpolicy:
        gains = tuple(float(g) for g in cfg.pid.split(","))
        # the reference's minibatches of 256 over the 20k collect, repeat
        # 4: about 312 grad steps a collect (ppol_cfg.py:44-49)
        nmb = max(1, (cfg.steps_per_collect * cfg.n_envs) // 256)
        common = dict(cost_limit=cfg.cost_limit, episode_len=1000,
                      device=cfg.device)
        if key == "ppol":
            algo = PPOLag(*dims, lagrangian_pid=gains, repeat=4,
                          n_minibatches=nmb, **common)
        elif key == "trpol":
            # repeat 4: the reference's repeat_per_collect (trpol_cfg.py:92)
            algo = TRPOLag(*dims, lagrangian_pid=gains, repeat=4, **common)
        elif key == "cpo":
            algo = CPO(*dims, repeat=4, **common)
        else:
            algo = FOCOPS(*dims, repeat=4, n_minibatches=nmb, **common)
        trainer = HostOnpolicyTrainer(
            algo, venv, epochs=epochs, step_per_epoch=cfg.step_per_epoch,
            steps_per_collect=cfg.steps_per_collect,
            episode_per_test=cfg.episode_per_test,
            cost_limit=cfg.cost_limit, seed=seed, verbose=False)
    else:
        common = dict(cost_limit=cfg.cost_limit, device=cfg.device)
        if key == "sacl":
            algo = SACLag(*dims, **common)
        elif key == "ddpgl":
            algo = DDPGLag(*dims, **common)
        else:
            algo = CVPO(*dims, max_episode_steps=1000, **common)
        trainer = HostOffpolicyTrainer(
            algo, venv, epochs=epochs, step_per_epoch=cfg.step_per_epoch,
            steps_per_collect=cfg.off_steps_per_collect,
            episode_per_test=cfg.episode_per_test,
            cost_limit=cfg.cost_limit, seed=seed, verbose=False)

    curve = {"env_step": [], "reward": [], "cost": []}
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
        "algo": key, "task": cfg.task, "seed": seed, "physics": "mujoco",
        "cost_limit": cfg.cost_limit, "budget": budget, "wall_s": wall,
        "steps_per_s": budget / wall,
        "final_reward": curve["reward"][-1], "final_cost": curve["cost"][-1],
        "best_reward": float(trainer.best_rew),
        "best_cost": float(trainer.best_cost),
        "curve": curve,
    }


def result_name(cfg: VelCurveCfg, key: str, seed: int) -> str:
    """The JAX runner's file name: ``-pid<gains>`` for ppol and trpol at
    other than the default gains."""
    tag = ("" if cfg.pid == DEFAULT_PID or key not in ("ppol", "trpol")
           else "-pid" + cfg.pid.replace(",", "_"))
    return f"{cfg.task}-{key}{tag}-s{seed}.json"


@cli(VelCurveCfg)
def main(cfg: VelCurveCfg) -> list[dict]:
    keys = cfg.algos.split(",")
    unknown = [k for k in keys if k not in ONPOLICY + OFFPOLICY]
    if unknown:
        raise KeyError(f"unknown algos {unknown}; known: "
                       f"{sorted(ONPOLICY + OFFPOLICY)}")
    out = results_dir(cfg.outdir)
    rows = []
    for key in keys:
        for seed in (int(s) for s in cfg.seeds.split(",")):
            print(f"=== {key} seed {seed} on {cfg.task} ===", flush=True)
            res = run_one(cfg, key, seed)
            with open(os.path.join(out, result_name(cfg, key, seed)),
                      "w") as f:
                json.dump(res, f)
            rows.append(res)
            print(f"    reward {res['final_reward']:8.1f}  "
                  f"cost {res['final_cost']:6.1f} (limit {cfg.cost_limit})  "
                  f"{res['steps_per_s']:,.0f} steps/s  {res['wall_s']:.0f}s",
                  flush=True)
    # the whole directory's summaries, from all its result JSONs
    summarize_dir(str(out))
    return rows


if __name__ == "__main__":
    main()
