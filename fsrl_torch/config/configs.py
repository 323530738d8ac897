"""Per-algorithm training configs and the task preset registry (port of
``fsrl_tpu/config/configs.py`` for the algorithms and tasks the port has).

Each algorithm has a config dataclass with the task, cost limit, seed,
algorithm knobs, collection knobs and logger knobs, and ``algo_kwargs()``
for the algorithm's constructor. The budget presets rescale epochs and cost
limit to a total env-step budget. Collection is ``n_envs`` x
``steps_per_collect`` fixed-length segments; the off-policy configs add the
replay buffer's size and the grad steps per env step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass
class TrainCfg:
    # general task params
    task: str = "SafetyCarCircle-v0"
    cost_limit: float = 10.0
    seed: int = 10
    use_default_cfg: bool = False
    # collection knobs (on-policy defaults)
    epochs: int = 200
    step_per_epoch: int = 10000
    n_envs: int = 20
    steps_per_collect: int = 500
    episode_per_test: int = 10
    # logger knobs
    logdir: str = "logs"
    project: str = "fast-safe-rl-torch"
    group: Optional[str] = None
    name: Optional[str] = None
    prefix: str = "fsrl-torch"
    suffix: Optional[str] = ""
    verbose: bool = True
    save_interval: int = 4
    # stop
    reward_threshold: Optional[float] = None
    # shared net / algo knobs
    hidden_sizes: Tuple[int, ...] = (128, 128)
    gamma: float = 0.99
    # distributed: data parallel over the ranks torchrun starts
    use_mesh: bool = False
    # where the entry points run: "cuda", or "cpu" for the plain versions
    device: str = "cuda"


@dataclass
class PPOLagCfg(TrainCfg):
    lr: float = 5e-4
    target_kl: float = 0.02
    vf_coef: float = 0.25
    max_grad_norm: Optional[float] = 0.5
    gae_lambda: float = 0.95
    eps_clip: float = 0.2
    dual_clip: Optional[float] = None
    value_clip: bool = False
    norm_adv: bool = True
    use_lagrangian: bool = True
    lagrangian_pid: Tuple[float, float, float] = (0.05, 0.0005, 0.1)
    rescaling: bool = True
    repeat: int = 4
    n_minibatches: int = 4

    def algo_kwargs(self) -> dict:
        return dict(
            hidden_sizes=self.hidden_sizes, lr=self.lr,
            target_kl=self.target_kl, vf_coef=self.vf_coef,
            max_grad_norm=self.max_grad_norm, gae_lambda=self.gae_lambda,
            eps_clip=self.eps_clip, dual_clip=self.dual_clip,
            value_clip=self.value_clip,
            advantage_normalization=self.norm_adv,
            use_lagrangian=self.use_lagrangian,
            lagrangian_pid=self.lagrangian_pid, rescaling=self.rescaling,
            gamma=self.gamma, repeat=self.repeat,
            n_minibatches=self.n_minibatches)


@dataclass
class TRPOLagCfg(TrainCfg):
    lr: float = 1e-3
    target_kl: float = 0.001
    backtrack_coeff: float = 0.8
    max_backtracks: int = 10
    optim_critic_iters: int = 20
    gae_lambda: float = 0.95
    norm_adv: bool = True
    use_lagrangian: bool = True
    lagrangian_pid: Tuple[float, float, float] = (0.05, 0.0005, 0.1)
    rescaling: bool = True

    def algo_kwargs(self) -> dict:
        return dict(
            hidden_sizes=self.hidden_sizes, lr=self.lr,
            target_kl=self.target_kl, backtrack_coeff=self.backtrack_coeff,
            max_backtracks=self.max_backtracks,
            optim_critic_iters=self.optim_critic_iters,
            gae_lambda=self.gae_lambda,
            advantage_normalization=self.norm_adv,
            use_lagrangian=self.use_lagrangian,
            lagrangian_pid=self.lagrangian_pid, rescaling=self.rescaling,
            gamma=self.gamma)


@dataclass
class CPOCfg(TrainCfg):
    lr: float = 1e-3
    target_kl: float = 0.01
    backtrack_coeff: float = 0.8
    # the step direction has unit norm, so a failed search must back off
    # very deep before the step that is applied all the same is harmless
    max_backtracks: int = 100
    optim_critic_iters: int = 10
    l2_reg: float = 1e-3
    gae_lambda: float = 0.95
    norm_adv: bool = True
    repeat: int = 1     # trust-region steps per collect

    def algo_kwargs(self) -> dict:
        return dict(
            hidden_sizes=self.hidden_sizes, lr=self.lr,
            target_kl=self.target_kl, backtrack_coeff=self.backtrack_coeff,
            max_backtracks=self.max_backtracks,
            optim_critic_iters=self.optim_critic_iters, l2_reg=self.l2_reg,
            gae_lambda=self.gae_lambda,
            advantage_normalization=self.norm_adv, gamma=self.gamma,
            repeat=self.repeat)


@dataclass
class FOCOPSCfg(TrainCfg):
    actor_lr: float = 3e-4
    critic_lr: float = 3e-4
    nu_max: float = 2.0
    nu_lr: float = 1e-2
    nu_init: float = 0.01
    l2_reg: float = 1e-3
    delta: float = 0.02
    eta: float = 0.02
    tem_lambda: float = 0.95
    gae_lambda: float = 0.95
    norm_adv: bool = True
    repeat: int = 4
    n_minibatches: int = 4

    def algo_kwargs(self) -> dict:
        return dict(
            hidden_sizes=self.hidden_sizes, actor_lr=self.actor_lr,
            critic_lr=self.critic_lr, nu_max=self.nu_max, nu_lr=self.nu_lr,
            nu_init=self.nu_init, l2_reg=self.l2_reg, delta=self.delta,
            eta=self.eta, tem_lambda=self.tem_lambda,
            gae_lambda=self.gae_lambda,
            advantage_normalization=self.norm_adv, gamma=self.gamma,
            repeat=self.repeat, n_minibatches=self.n_minibatches)


@dataclass
class OffpolicyCfg(TrainCfg):
    """The off-policy collection knobs: replay buffer size, grad steps per
    env step, and short collects from few envs."""

    buffer_size: int = 100000
    update_per_step: float = 0.2
    steps_per_collect: int = 100
    n_envs: int = 10
    epochs: int = 200


@dataclass
class DDPGLagCfg(OffpolicyCfg):
    actor_lr: float = 1e-4
    critic_lr: float = 1e-3
    tau: float = 0.005
    exploration_noise: float = 0.1
    n_step: int = 3
    use_lagrangian: bool = True
    lagrangian_pid: Tuple[float, float, float] = (0.5, 0.001, 0.1)
    rescaling: bool = True
    batch_size: int = 256

    def algo_kwargs(self) -> dict:
        return dict(
            hidden_sizes=self.hidden_sizes, actor_lr=self.actor_lr,
            critic_lr=self.critic_lr, tau=self.tau,
            exploration_noise=self.exploration_noise, n_step=self.n_step,
            use_lagrangian=self.use_lagrangian,
            lagrangian_pid=self.lagrangian_pid, rescaling=self.rescaling,
            gamma=self.gamma, batch_size=self.batch_size)


@dataclass
class SACLagCfg(OffpolicyCfg):
    actor_lr: float = 5e-4
    critic_lr: float = 1e-3
    alpha: float = 0.005
    auto_alpha: bool = True
    alpha_lr: float = 3e-4
    tau: float = 0.05
    n_step: int = 2
    use_lagrangian: bool = True
    lagrangian_pid: Tuple[float, float, float] = (0.05, 0.0005, 0.1)
    rescaling: bool = True
    batch_size: int = 256

    def algo_kwargs(self) -> dict:
        return dict(
            hidden_sizes=self.hidden_sizes, actor_lr=self.actor_lr,
            critic_lr=self.critic_lr, alpha=self.alpha,
            auto_alpha=self.auto_alpha, alpha_lr=self.alpha_lr, tau=self.tau,
            n_step=self.n_step, use_lagrangian=self.use_lagrangian,
            lagrangian_pid=self.lagrangian_pid, rescaling=self.rescaling,
            gamma=self.gamma, batch_size=self.batch_size)


@dataclass
class CVPOCfg(OffpolicyCfg):
    actor_lr: float = 5e-4
    critic_lr: float = 1e-3
    gamma: float = 0.98
    n_step: int = 2
    tau: float = 0.05
    estep_iter_num: int = 1
    estep_kl: float = 0.02
    estep_dual_max: float = 20.0
    estep_dual_lr: float = 0.02
    sample_act_num: int = 16
    mstep_iter_num: int = 1
    mstep_kl_mu: float = 0.005
    mstep_kl_std: float = 0.0005
    mstep_dual_max: float = 0.5
    mstep_dual_lr: float = 0.1
    double_critic: bool = True
    batch_size: int = 256

    def algo_kwargs(self) -> dict:
        return dict(
            hidden_sizes=self.hidden_sizes, actor_lr=self.actor_lr,
            critic_lr=self.critic_lr, gamma=self.gamma, n_step=self.n_step,
            tau=self.tau, estep_iter_num=self.estep_iter_num,
            estep_kl=self.estep_kl, estep_dual_max=self.estep_dual_max,
            estep_dual_lr=self.estep_dual_lr,
            sample_act_num=self.sample_act_num,
            mstep_iter_num=self.mstep_iter_num, mstep_kl_mu=self.mstep_kl_mu,
            mstep_kl_std=self.mstep_kl_std,
            mstep_dual_max=self.mstep_dual_max,
            mstep_dual_lr=self.mstep_dual_lr,
            double_critic=self.double_critic, batch_size=self.batch_size)


# ---------------------------------------------------------------------------
# Budget presets: scale the total env-step budget.
# ---------------------------------------------------------------------------

def preset(cfg, total_steps: int, cost_limit: Optional[float] = None):
    """Rescale a config's epochs (and optionally its cost limit) to a total
    env-step budget, in place."""
    cfg.epochs = max(1, total_steps // cfg.step_per_epoch)
    if cost_limit is not None:
        cfg.cost_limit = cost_limit
    return cfg


def bullet_1m(cfg):
    """Bullet 1M-step preset, cost limit 10."""
    return preset(cfg, 1_000_000, 10.0)


def bullet_5m(cfg):
    """Bullet 5M-step preset, cost limit 10."""
    return preset(cfg, 5_000_000, 10.0)


def bullet_10m(cfg):
    """Bullet 10M-step preset, cost limit 10."""
    return preset(cfg, 10_000_000, 10.0)


def mujoco_base(cfg):
    """MuJoCo / navigation base preset: 5M steps, 20,000 a epoch, cost
    limit 25."""
    cfg.step_per_epoch = 20000
    return preset(cfg, 5_000_000, 25.0)


def mujoco_2m(cfg):
    """MuJoCo 2M-step preset."""
    cfg.step_per_epoch = 20000
    return preset(cfg, 2_000_000, 25.0)


def mujoco_10m(cfg):
    """MuJoCo 10M-step preset."""
    cfg.step_per_epoch = 20000
    return preset(cfg, 10_000_000, 25.0)


def mujoco_20m(cfg):
    """MuJoCo 20M-step preset."""
    cfg.step_per_epoch = 20000
    return preset(cfg, 20_000_000, 25.0)


# Per-task presets for the tasks the port registers. ``None`` is the
# algorithm's default budget (2M steps).
TASK_TO_PRESET = {
    "SafetyCarRun-v0": bullet_1m,
    "SafetyBallRun-v0": bullet_1m,
    "SafetyBallCircle-v0": bullet_1m,
    "SafetyBallCircle2C-v0": bullet_1m,
    "SafetyCarCircle-v0": None,
    "SafetyDroneRun-v0": None,
    "SafetyAntRun-v0": None,
    "SafetyDroneCircle-v0": bullet_5m,
    "SafetyAntCircle-v0": bullet_10m,
    # the navigation suite (Safety-Gymnasium's tasks)
    **{f"Safety{robot}Circle{lvl}-v0": mujoco_2m
       for robot in ("Point", "Car") for lvl in (1, 2)},
    **{f"Safety{robot}{task}{lvl}-v0": mujoco_base
       for robot in ("Point", "Car") for task in ("Goal", "Button", "Push")
       for lvl in (1, 2)},
    # Safety-Gymnasium's velocity suite (gymnasium MuJoCo on the host path)
    "SafetyHalfCheetahVelocity-v1": mujoco_base,
    "SafetyHopperVelocity-v1": mujoco_base,
    "SafetySwimmerVelocity-v1": mujoco_base,
    "SafetyWalker2dVelocity-v1": mujoco_10m,
    "SafetyAntVelocity-v1": mujoco_10m,
    "SafetyHumanoidVelocity-v1": mujoco_20m,
}

# Reference task ids (with a "Gymnasium" infix) -> the port's.
TASK_ALIASES = {
    f"Safety{robot}{task}{lvl}Gymnasium-v0": f"Safety{robot}{task}{lvl}-v0"
    for robot in ("Point", "Car")
    for task in ("Circle", "Goal", "Button", "Push") for lvl in (1, 2)
}
TASK_ALIASES.update({
    f"Safety{b}VelocityGymnasium-v1": f"Safety{b}Velocity-v1"
    for b in ("HalfCheetah", "Hopper", "Swimmer", "Walker2d", "Ant",
              "Humanoid")
})


def apply_task_preset(cfg):
    """Apply the task's registered budget preset to ``cfg`` in place,
    translating a reference task id (``*Gymnasium-v0``, ``-v1``) first."""
    cfg.task = TASK_ALIASES.get(cfg.task, cfg.task)
    fn = TASK_TO_PRESET.get(cfg.task)
    return fn(cfg) if fn else cfg
