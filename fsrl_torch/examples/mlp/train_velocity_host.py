"""Train PPO-Lagrangian on a Safety-Gymnasium velocity task (real MuJoCo)
through the host path: the envs step on the host, a CPU copy of the actor
acts, and each segment's update runs on the card (port of
``examples/mlp/train_velocity_host.py``).

    python -m fsrl_torch.examples.mlp.train_velocity_host \\
        --task SafetyHumanoidVelocity-v1
    python -m fsrl_torch.examples.mlp.train_velocity_host --device cpu

Needs gymnasium and mujoco (the env), and tensorboardX (the logger) where
``run`` is given no logger. Flags are the fields of :class:`VelCfg`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from fsrl_torch.algos.ppo_lag import PPOLag
from fsrl_torch.config.cli import cli
from fsrl_torch.envs.velocity import make_velocity_vector_env, velocity_tasks
from fsrl_torch.trainer.host_trainer import HostOnpolicyTrainer
from fsrl_torch.utils.logger import BaseLogger, TensorboardLogger


@dataclass
class VelCfg:
    task: str = "SafetyHalfCheetahVelocity-v1"
    cost_limit: float = 25.0
    epochs: int = 100
    step_per_epoch: int = 20000
    n_envs: int = 10
    steps_per_collect: int = 500
    episode_per_test: int = 4
    seed: int = 0
    logdir: str = "logs/velocity"
    device: str = "cuda"


def run(cfg: VelCfg, make_venv: Optional[Callable] = None,
        logger: Optional[BaseLogger] = None) -> dict:
    """Train as ``cfg`` says and return the trainer's last info.
    ``make_venv(n_envs)`` builds the vector env (default: ``cfg.task``'s
    host velocity env) and ``logger`` replaces the TensorBoard logger."""
    if make_venv is None:
        if cfg.task not in velocity_tasks():
            raise ValueError(f"unknown task {cfg.task!r}: choose from "
                             f"{velocity_tasks()}")
        make_venv = lambda n: make_velocity_vector_env(cfg.task, n_envs=n)
    venv = make_venv(cfg.n_envs)
    try:
        algo = PPOLag(venv.observation_size, venv.action_size,
                      cost_limit=cfg.cost_limit, device=cfg.device)
        if logger is None:
            logger = TensorboardLogger(cfg.logdir, name=f"ppol-{cfg.task}")
        trainer = HostOnpolicyTrainer(
            algo, venv, logger=logger, epochs=cfg.epochs,
            step_per_epoch=cfg.step_per_epoch,
            steps_per_collect=cfg.steps_per_collect,
            episode_per_test=cfg.episode_per_test, cost_limit=cfg.cost_limit,
            seed=cfg.seed)
        return trainer.run()
    finally:
        venv.close()


@cli(VelCfg)
def main(cfg: VelCfg):
    info = run(cfg)
    print("done:", info)


if __name__ == "__main__":
    main()
