"""The shared code of the per-algorithm command lines (port of
``examples/mlp/common.py``): ``train_<algo>_agent`` trains one algorithm
as its config says, ``eval_<algo>_agent`` reloads a run directory and
evaluates it.

    python -m fsrl_torch.examples.mlp.train_ppol_agent \
        --task SafetyCarCircle-v0
    python -m fsrl_torch.examples.mlp.train_ppol_agent \\
        --config fsrl_torch/examples/yaml_cfgs/demo_ppol_cfg.yaml
    python -m fsrl_torch.examples.mlp.eval_ppol_agent --path <run directory>
    torchrun --nproc_per_node <cards> -m \\
        fsrl_torch.examples.mlp.train_ppol_agent --use_mesh true

Flags are the fields of the algorithm's config dataclass
(:mod:`fsrl_torch.config.configs`); ``--device cpu`` runs the plain
versions on the CPU. ``--use_mesh true`` trains data parallel over the
ranks ``torchrun`` starts, one a card (``n_envs`` is the global count);
without ``torchrun`` it raises. The run directory
(``<logdir>/<project>/<group>/<name>``) receives ``config.yaml``,
``progress.txt`` and ``checkpoint/model.pt`` and ``model_best.pt``, and
TensorBoard events where tensorboardX is installed.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import inspect
import os
from typing import Optional

import torch.distributed as dist

from fsrl_torch.config.configs import apply_task_preset
from fsrl_torch.parallel.mesh import DPGroup, make_mesh
from fsrl_torch.utils.exp_util import (auto_name, load_config_and_model,
                                       seed_all)
from fsrl_torch.utils.logger import (BaseLogger, DummyLogger,
                                     TensorboardLogger)


def run_logger(logdir: str, name: str) -> BaseLogger:
    """TensorBoard where tensorboardX is installed, else the text logger
    (progress.txt, config and checkpoints)."""
    if importlib.util.find_spec("tensorboardX") is not None:
        return TensorboardLogger(logdir, name=name)
    print("tensorboardX is not installed: logging to progress.txt only",
          flush=True)
    return BaseLogger(logdir, name=name)


def run_train(cfg, agent_cls, default_cfg,
              logger: Optional[BaseLogger] = None) -> dict:
    """Train ``agent_cls`` as ``cfg`` says (``default_cfg`` names the run
    by what differs from it), evaluate the result, and return the trainer's
    last info. ``logger`` replaces the run's logger (on rank 0)."""
    seed_all(cfg.seed)
    if cfg.use_default_cfg:
        cfg = apply_task_preset(cfg)
    if not cfg.use_mesh:
        return _train(cfg, agent_cls, default_cfg, logger, None)
    owns_group = not dist.is_initialized()
    # before the agent: the mesh makes this rank's card the current one
    mesh = make_mesh(device=None if cfg.device == "cuda" else cfg.device)
    try:
        return _train(cfg, agent_cls, default_cfg, logger, mesh)
    finally:
        if owns_group:
            dist.destroy_process_group()


def _train(cfg, agent_cls, default_cfg, logger, mesh) -> dict:
    rank0 = mesh is None or DPGroup.of(mesh).rank == 0
    if not rank0:
        logger = DummyLogger()
    elif logger is None:
        name = cfg.name or auto_name(default_cfg, cfg, cfg.prefix,
                                     cfg.suffix or "")
        group = cfg.group or f"{cfg.task}-cost-{int(cfg.cost_limit)}"
        logger = run_logger(os.path.join(cfg.logdir, cfg.project, group),
                             name)
    logger.save_config(dataclasses.asdict(cfg))

    agent = agent_cls(cfg.task, logger=logger, cost_limit=cfg.cost_limit,
                      seed=cfg.seed, device=cfg.device, **cfg.algo_kwargs())
    info = agent.learn(
        epochs=cfg.epochs, step_per_epoch=cfg.step_per_epoch,
        n_envs=cfg.n_envs, steps_per_collect=cfg.steps_per_collect,
        episode_per_test=cfg.episode_per_test,
        save_model_interval=cfg.save_interval,
        reward_threshold=cfg.reward_threshold,
        buffer_size=getattr(cfg, "buffer_size", 100000),
        update_per_step=getattr(cfg, "update_per_step", 0.2),
        mesh=mesh, verbose=cfg.verbose)
    logger.print(f"train done: {info}")
    if rank0:
        rew, length, cost = agent.evaluate()
        logger.print(f"final eval: reward {rew:.1f}, cost {cost:.1f}, "
                     f"len {length:.0f}")
    return info


def run_eval(path: str, agent_cls, best: bool = True, n_episodes: int = 10,
             device: str = "cuda") -> tuple[float, float, float]:
    """Reload a run directory's ``config.yaml`` and checkpoint, rebuild the
    agent on ``device`` and evaluate it: ``(reward, length, cost)``."""
    config, _ = load_config_and_model(path, best=best, target=None)
    agent = agent_cls(config["task"], cost_limit=config["cost_limit"],
                      seed=config.get("seed", 0), device=device,
                      **_algo_kwargs_from_config(agent_cls, config))
    _, agent.state = load_config_and_model(path, best=best,
                                           target=agent.state)
    rew, length, cost = agent.evaluate(n_episodes=n_episodes)
    print(f"Eval reward: {rew:.2f}, cost: {cost:.2f}, length: {length:.1f}",
          flush=True)
    return rew, length, cost


def _algo_kwargs_from_config(agent_cls, config: dict) -> dict:
    """The saved config's values that the algorithm's constructor takes
    (the config's ``norm_adv`` is its ``advantage_normalization``)."""
    params = inspect.signature(agent_cls.algo_cls.__init__).parameters
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in config.items()
          if k in params and k not in ("self", "obs_dim", "act_dim",
                                       "cost_limit", "device")}
    if "norm_adv" in config and "advantage_normalization" in params:
        kw["advantage_normalization"] = config["norm_adv"]
    return kw


def eval_main(agent_cls, argv: Optional[list[str]] = None):
    """The ``eval_<algo>_agent`` command line."""
    p = argparse.ArgumentParser(
        description=f"Evaluate a trained {agent_cls.name} run directory")
    p.add_argument("--path", type=str, required=True)
    p.add_argument("--best", action="store_true", default=True)
    p.add_argument("--eval_episodes", type=int, default=10)
    p.add_argument("--device", type=str, default="cuda")
    a = p.parse_args(argv)
    return run_eval(a.path, agent_cls, best=a.best,
                    n_episodes=a.eval_episodes, device=a.device)
