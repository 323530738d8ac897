"""What the hand-assembled scripts share (port of
``examples/customized/custom_common.py``): the run directory (config.yaml
and the training state's checkpoint) and the reload-and-evaluate of a run
directory.

The run directory is ``<logdir>/<name>-<task>-s<seed>/<name>``; its
checkpoint is the port's ``checkpoint/model.pt`` (``model_best.pt``), a
``torch.save`` file, not the JAX package's orbax directory.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from fsrl_torch.data.collector import evaluate
from fsrl_torch.device import resolve_device
from fsrl_torch.envs import make
from fsrl_torch.examples.mlp.common import run_logger
from fsrl_torch.utils.checkpoint import save_checkpoint
from fsrl_torch.utils.exp_util import load_config_and_model, seed_all
from fsrl_torch.utils.logger import BaseLogger


def setup_run(cfg, name: str) -> BaseLogger:
    """Seed, create the run directory, snapshot the config, return a
    logger (TensorBoard where tensorboardX is installed)."""
    seed_all(cfg.seed)
    logdir = os.path.join(cfg.logdir, f"{name}-{cfg.task}-s{cfg.seed}")
    logger = run_logger(logdir, name)
    logger.save_config(dataclasses.asdict(cfg))
    return logger


def save_model(logger: BaseLogger, state, best: bool = False) -> str:
    """Checkpoint the whole training state (parameters, optimizers,
    multiplier and dual states) under the run directory."""
    name = "model_best.pt" if best else "model.pt"
    path = os.path.join(logger.log_dir, "checkpoint", name)
    save_checkpoint(path, state)
    return path


def evaluate_policy(env, algo, params, n_episodes: int, seed: int
                    ) -> tuple[float, float, float]:
    """Episode-exact evaluation of ``params``, drawing from a generator
    seeded with ``seed + 1``: ``(reward, length, cost)``."""
    g = torch.Generator(device=algo.device).manual_seed(seed + 1)
    out = evaluate(env, algo.act_fn_eval, params, g, n_episodes)
    return (float(out["reward"]), float(out["length"]),
            float(out["cost"]))


def eval_checkpoint(path: str, build_algo, n_episodes: int = 10,
                    best: bool = False, seed: int = 0,
                    device: str = "cuda") -> tuple[float, float, float]:
    """Reload ``config.yaml`` and the checkpoint of a run directory,
    rebuild the algorithm with ``build_algo(env, config, device)`` and run
    an episode-exact evaluation: ``(reward, length, cost)``."""
    device = resolve_device(device)
    config, _ = load_config_and_model(path, best=best, target=None)
    env = make(config["task"])
    algo = build_algo(env, config, device)
    _, state = load_config_and_model(path, best=best,
                                     target=algo.init(seed))
    rew, length, cost = evaluate_policy(env, algo, state.params, n_episodes,
                                        seed)
    print(f"Eval reward: {rew:.2f}, cost: {cost:.2f}, length: {length:.1f}",
          flush=True)
    return rew, length, cost


def eval_main(build_algo, argv=None) -> tuple[float, float, float]:
    """The ``eval_*`` command line: ``--path``, ``--best``,
    ``--eval_episodes`` and ``--device``."""
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--path", type=str, required=True)
    p.add_argument("--best", action="store_true")
    p.add_argument("--eval_episodes", type=int, default=10)
    p.add_argument("--device", type=str, default="cuda")
    a = p.parse_args(argv)
    return eval_checkpoint(a.path, build_algo, n_episodes=a.eval_episodes,
                           best=a.best, device=a.device)
