"""Learning curves: train algorithms on a task with a real cost limit and
record each epoch's test reward and cost (port of
``benchmarks/run_curves.py``, the reproduction of the reference's
benchmark protocol at a given env-step budget).

    python -m fsrl_torch.examples.run_curves --task SafetyCarCircle-v0 \\
        --algos ppol --seeds 0 --budget 1000000
    python -m fsrl_torch.examples.run_curves --task SafetyBallCircle-v0 \\
        --algos sacl --seeds 0 --off_budget 300000 [--device cpu]

Writes one JSON per (algo, seed), ``<outdir>/<task>-<algo>-s<seed>.json``
with the JAX runner's keys, then rewrites the directory's summary tables
(:func:`fsrl_torch.examples.make_summaries.summarize_dir`).

The off-policy trainer gets the JAX runner's ``update_chunk=256`` and
``fuse_iters=off_fuse_iters``: on the card its dispatches replay CUDA
graphs (:mod:`fsrl_torch.trainer.graphs`). It differs from the JAX runner
in two ways:

* the default ``outdir`` is ``logs/curves`` (git ignores ``logs/``), and a
  run refuses to write into the repository's ``benchmarks/``, which holds
  the JAX package's committed results;
* no retries: the JAX runner tries a run three times (for flaky remote
  compiles); here an exception ends the run with a nonzero exit status.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from pathlib import Path

from fsrl_torch.agent import (CPOAgent, CVPOAgent, DDPGLagAgent,
                              FOCOPSAgent, PPOLagAgent, SACLagAgent,
                              TRPOLagAgent)
from fsrl_torch.config.cli import cli
from fsrl_torch.examples.make_summaries import summarize_dir
from fsrl_torch.trainer.trainer import OffpolicyTrainer, OnpolicyTrainer

AGENTS = {
    "ppol": (PPOLagAgent, True, {}),
    "trpol": (TRPOLagAgent, True, {"target_kl": 0.005}),
    "cpo": (CPOAgent, True, {}),
    "focops": (FOCOPSAgent, True, {}),
    # a softer PID than DDPG-Lag's default (0.5, 0.001, 0.1): 500-step
    # episodes make the constraint error about 10x the reference env's, and
    # kp 0.5 then drives the multiplier into a feasible / infeasible limit
    # cycle
    "ddpgl": (DDPGLagAgent, False, {"lagrangian_pid": (0.05, 0.0005, 0.1)}),
    "sacl": (SACLagAgent, False, {}),
    "cvpo": (CVPOAgent, False, {}),
}

BENCHMARKS = Path(__file__).resolve().parents[2] / "benchmarks"


def results_dir(outdir: str) -> Path:
    """``outdir``, resolved and made; refused inside the repository's
    ``benchmarks/``, which holds the JAX package's committed results."""
    out = Path(outdir).resolve()
    if out == BENCHMARKS or BENCHMARKS in out.parents:
        raise ValueError(f"{outdir} lies in benchmarks/, which holds the "
                         "JAX package's committed results")
    os.makedirs(out, exist_ok=True)
    return out


@dataclass
class CurveCfg:
    task: str = "SafetyBallRun-v0"
    cost_limit: float = 25.0
    budget: int = 500000            # on-policy env-step budget
    off_budget: int = 150000        # off-policy env-step budget
    step_per_epoch: int = 10000
    n_envs: int = 20
    steps_per_collect: int = 500
    off_n_envs: int = 8
    off_steps_per_collect: int = 125
    # 10 cycles of 1,000-step collects a dispatch (one graph on the card)
    off_fuse_iters: int = 10
    episode_per_test: int = 10
    algos: str = "ppol,trpol,cpo,focops,ddpgl,sacl,cvpo"
    seeds: str = "0"
    outdir: str = "logs/curves"
    log_every: int = 5              # train-metric fetch cadence (collects)
    # optional PID override of the PID-Lagrangian on-policy algorithms
    # (ppol, trpol): "kp,ki,kd"
    pid_onpolicy: str = ""
    sigma_floor: float = 0.0        # trpol, cpo: an entropy floor
    qc_ucb: float = 0.0             # sacl: cost-Q head-disagreement pessimism
    nu_max: float = 0.0             # focops: nu ceiling (0 = default 2.0)
    device: str = "cuda"


def agent_kwargs(cfg: CurveCfg, key: str) -> dict:
    """The algorithm's keywords: its ``AGENTS`` overrides and the
    optional ones of ``cfg`` that apply to it."""
    kw = dict(AGENTS[key][2])
    if cfg.pid_onpolicy and key in ("ppol", "trpol"):
        kw["lagrangian_pid"] = tuple(
            float(x) for x in cfg.pid_onpolicy.split(","))
    if cfg.nu_max and key == "focops":
        kw["nu_max"] = cfg.nu_max
    if cfg.qc_ucb and key == "sacl":
        kw["qc_ucb"] = cfg.qc_ucb
    if cfg.sigma_floor and key in ("trpol", "cpo"):
        kw["sigma_floor"] = cfg.sigma_floor
    return kw


def run_one(cfg: CurveCfg, key: str, seed: int) -> dict:
    """Train one (algo, seed) at the budget and return its result row."""
    agent_cls, onpolicy, _ = AGENTS[key]
    budget = cfg.budget if onpolicy else cfg.off_budget
    epochs = max(1, budget // cfg.step_per_epoch)
    agent = agent_cls(cfg.task, cost_limit=cfg.cost_limit, seed=seed,
                      device=cfg.device, **agent_kwargs(cfg, key))
    curve = {"env_step": [], "reward": [], "cost": []}
    t0 = time.time()

    common = dict(epochs=epochs, step_per_epoch=cfg.step_per_epoch,
                  episode_per_test=cfg.episode_per_test, verbose=False,
                  log_every=cfg.log_every)
    if onpolicy:
        common.update(n_envs=cfg.n_envs,
                      steps_per_collect=cfg.steps_per_collect)
        tcls = OnpolicyTrainer
    else:
        common.update(n_envs=cfg.off_n_envs,
                      steps_per_collect=cfg.off_steps_per_collect,
                      update_per_step=0.2, update_chunk=256,
                      fuse_iters=cfg.off_fuse_iters)
        tcls = OffpolicyTrainer
    # the trainer is driven epoch by epoch, so that each epoch's test is
    # recorded
    trainer = tcls(agent.algo, agent.env, agent.logger,
                   cost_limit=cfg.cost_limit, seed=seed, stop_fn=None,
                   state=agent.state, **common)
    for _, _, info in trainer:
        curve["env_step"].append(info["env_step"])
        curve["reward"].append(info["test_reward"])
        curve["cost"].append(info["test_cost"])
    agent.state = trainer.state
    wall = time.time() - t0
    rew, length, cost = agent.evaluate(n_episodes=20, seed=seed + 1000)
    return {
        "algo": key, "task": cfg.task, "seed": seed,
        **({"pid": cfg.pid_onpolicy} if cfg.pid_onpolicy and
           key in ("ppol", "trpol") else {}),
        **({"nu_max": cfg.nu_max} if cfg.nu_max and key == "focops" else {}),
        **({"sigma_floor": cfg.sigma_floor} if cfg.sigma_floor and
           key in ("trpol", "cpo") else {}),
        **({"qc_ucb": cfg.qc_ucb} if cfg.qc_ucb and key == "sacl" else {}),
        "cost_limit": cfg.cost_limit, "budget": budget, "wall_s": wall,
        "n_envs": common["n_envs"],
        "steps_per_collect": common["steps_per_collect"],
        "step_per_epoch": cfg.step_per_epoch,
        "steps_per_s": budget / wall,
        "final_reward": rew, "final_cost": cost, "final_length": length,
        # the feasibility-first best test result (the reference's
        # model-selection rule): what a user would deploy
        "best_reward": float(trainer.best_rew),
        "best_cost": float(trainer.best_cost),
        "curve": curve,
    }


@cli(CurveCfg)
def main(cfg: CurveCfg) -> list[dict]:
    keys = cfg.algos.split(",")
    unknown = [k for k in keys if k not in AGENTS]
    if unknown:
        raise KeyError(f"unknown algos {unknown}; known: {sorted(AGENTS)}")
    out = results_dir(cfg.outdir)
    rows = []
    for key in keys:
        for seed in (int(s) for s in cfg.seeds.split(",")):
            print(f"=== {key} seed {seed} on {cfg.task} ===", flush=True)
            res = run_one(cfg, key, seed)
            path = out / f"{cfg.task}-{key}-s{seed}.json"
            with open(path, "w") as f:
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
