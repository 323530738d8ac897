"""The collector's segment as one CUDA kernel (``csrc/rollout.cu``).

For the feedforward Gaussian actor of the on-policy algorithms (PPO-Lag,
FOCOPS, TRPO-Lag, CPO), with two ReLU layers of 128 or of 256 units, on
the car and ball envs, one launch runs a whole ``(T, N)`` segment: the
actor's forward and sample, ``map_action`` and the env's clamp, the
physics, the task's observation, reward and cost, the step clock, the
auto-reset and the running :class:`EpisodeStats`, each step's
:class:`Transition` written into the segment. The loop in
:func:`fsrl_torch.data.collector.make_rollout_fn` issues about 160 small
kernels an env step for the same work.

The randomness stays PyTorch's: :func:`segment_draws` makes, step by step,
the actions' ``randn`` and the env's reset ``rand`` draws with the loop's
shapes and in the loop's order, so the generator gives the same numbers.
Given the same actions the kernel's env, reset and accumulator arithmetic
is the loop's bit for bit (PyTorch's operation order, no contraction); the
actor's products are f32 FMAs summed in another order than cuBLAS's, the
only source of difference. The episode aggregates are summed in a fixed
order, so a graph replay equals its eager call bit for bit.

The kernel form is chosen by :func:`fsrl_torch.data.collector.rollout_form`
where :func:`kernel_fits` holds. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from fsrl_torch.envs import ball, car
from fsrl_torch.envs.base import EnvState
from fsrl_torch.envs.tasks import CircleBoundSpeedTask, CircleTask, RunTask
from fsrl_torch.nets.distributions import LOG_SQRT_2PI
from fsrl_torch.nets.mlp import GaussianActor
from fsrl_torch.ops import kernels
from fsrl_torch.types import EpisodeStats, Transition

WIDTHS = (128, 256)   # hidden width of both layers (csrc/rollout.cu)
A = 2         # actions
DMAX = 16     # observation width
MMAX = 2      # cost channels

_CONSTS = ("act_low act_high act_range dt accel drag dt_steer inv_vel_scale "
           "inv_pos_scale y_lim inv_y_lim speed_limit inv_speed_limit "
           "inv_v_target radius inv_radius x_lim theta_low theta_range "
           "half_pi r_low r_range pos_low pos_range s_low s_range max_action "
           "sigma_floor log_sqrt_2pi").split()
_POINTERS = ("w1 b1 w2 b2 wmu bmu log_sigma noise u0 u1 act_in logp_in pos "
             "sa sb obs t pos_o sa_o sb_o obs_o t_o ep_r ep_c ep_l ep_r_o "
             "ep_c_o ep_l_o n_episodes n_steps n_term n_trunc sum_r sum_c "
             "sum_l n_episodes_o n_steps_o n_term_o n_trunc_o sum_r_o sum_c_o "
             "sum_l_o tr_obs tr_act tr_obs_next tr_reward tr_cost tr_logp "
             "tr_term tr_trunc part_f part_i counter").split()
_INTS = "T N D M max_steps floored".split()


class _Consts(ctypes.Structure):
    _fields_ = [(k, ctypes.c_float) for k in _CONSTS]


class _Args(ctypes.Structure):
    _fields_ = ([(k, ctypes.c_void_p) for k in _POINTERS]
                + [(k, ctypes.c_int) for k in _INTS])


def _inv(x: float) -> float:
    """ATen's division of a CUDA tensor by a Python float is a product
    with the float reciprocal of the float divisor."""
    return float(np.float32(1.0) / np.float32(x))


def _kinds(env) -> tuple[int, int] | None:
    """``(env, task)`` as ``csrc/rollout.cu`` numbers them, or None."""
    kind = {car.CarEnv: 0, ball.BallEnv: 1}.get(type(env))
    task = {RunTask: 0, CircleTask: 1, CircleBoundSpeedTask: 2}.get(
        type(getattr(env, "task", None)))
    return None if kind is None or task is None else (kind, task)


def kernel_fits(env, actor) -> bool:
    """Whether the kernel runs this env and actor: the car or ball env
    with the Run, Circle or two-constraint Circle task; a
    :class:`GaussianActor` with a free log-sigma, a bounded mean and two
    ReLU layers of 128 or of 256 units, in f32."""
    if _kinds(env) is None or not isinstance(actor, GaussianActor):
        return False
    layers = actor.trunk.layers
    D = env.observation_size
    H = layers[0].weight.shape[0] if len(layers) == 2 else None
    return (not actor.conditioned_sigma and not actor.unbounded
            and actor.trunk.out is None
            and actor.trunk.compute_dtype in (None, torch.float32)
            and H in WIDTHS
            and tuple(layers[0].weight.shape) == (H, D)
            and tuple(layers[1].weight.shape) == (H, H)
            and tuple(actor.mu.weight.shape) == (A, H)
            and env.action_size == A and D <= DMAX
            and env.num_costs <= MMAX
            and all(p.dtype == torch.float32 for p in actor.parameters()))


def _consts(env, actor) -> _Consts:
    """The kernel's constants, each the float PyTorch computes with: a
    Python float rounded to float32, or a divisor's reciprocal."""
    is_car = isinstance(env, car.CarEnv)
    mod, task = (car if is_car else ball), env.task
    c = dict(act_low=env.action_low, act_high=env.action_high,
             act_range=env.action_high - env.action_low,
             dt=mod.DT, accel=mod.ACCEL, drag=mod.DRAG,
             dt_steer=car.DT * car.STEER_RATE,
             inv_vel_scale=_inv(mod.VEL_SCALE),
             inv_pos_scale=_inv(10.0),          # ball.py: pos / 10.0
             max_action=actor.max_action,
             sigma_floor=actor.sigma_floor or 1.0,
             log_sqrt_2pi=LOG_SQRT_2PI)
    if isinstance(task, RunTask):
        c.update(y_lim=task.y_lim, inv_y_lim=_inv(task.y_lim),
                 speed_limit=task.speed_limit,
                 inv_speed_limit=_inv(task.speed_limit),
                 inv_v_target=_inv(task.v_target),
                 # scale(u, -0.5, 0.5); the car's heading
                 # scale(u, -0.3, 0.3), the ball's velocity (-0.1, 0.1)
                 pos_low=-0.5, pos_range=0.5 - (-0.5),
                 s_low=-0.3 if is_car else -0.1,
                 s_range=0.3 - (-0.3) if is_car else 0.1 - (-0.1))
    else:
        c.update(radius=task.radius, inv_radius=_inv(task.radius),
                 x_lim=task.x_lim,
                 # scale(u, 0.0, 2 pi); the car's heading theta + pi / 2;
                 # the ball's radius + scale(u, -0.5, 0.5)
                 theta_low=0.0, theta_range=2 * math.pi - 0.0,
                 half_pi=math.pi / 2, r_low=-0.5, r_range=0.5 - (-0.5))
        if hasattr(task, "speed_limit"):
            c.update(speed_limit=task.speed_limit,
                     inv_speed_limit=_inv(task.speed_limit))
    return _Consts(**c)


def tile(n_envs: int, device: torch.device, hidden: int) -> int:
    """The envs a block at hidden 128: 32, unless that leaves fewer than
    two blocks for each SM, when 16 (two blocks of 16 share an SM's
    products and hide each other's env steps; 16 and 32 give the same
    segment). At 256, the envs of a cluster of two blocks: 64."""
    if hidden == 256:
        return 64
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return 16 if (n_envs + 31) // 32 < 2 * sms else 32


def segment_draws(env, T: int, N: int, generator: torch.Generator
                  ) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """The segment's draws, step by step in the loop's order: the actions'
    noise, ``(T, N, A)``, then each reset draw of ``_reset_draw_shapes``,
    ``(T, N, ...)``. Each is the ``randn`` / ``rand`` call of the loop's
    step, written into its step's row."""
    dev = generator.device
    noise = torch.empty((T, N, env.action_size), device=dev)
    resets = [torch.empty((T,) + tuple(s), device=dev)
              for s in env._reset_draw_shapes(N)]
    for t in range(T):
        noise[t].normal_(generator=generator)
        for u in resets:
            u[t].uniform_(generator=generator)
    return noise, resets


@torch.no_grad()
def rollout_segment(env, actor, env_state, stats, generator: torch.Generator,
                    T: int, actions: tuple | None = None):
    """``T`` steps of every env of ``env_state`` in one launch: the new
    env state, statistics and the ``(T, N, ...)`` transitions, as the loop
    of :func:`fsrl_torch.data.collector.make_rollout_fn` makes them.
    ``actions``, ``(act (T, N, A), logp (T, N))``, replaces the actor's
    (tests: the env, reset and accumulators alone); the draws are made
    all the same."""
    kinds = _kinds(env)
    kernels.require(kinds is not None and kernel_fits(env, actor),
                    "rollout kernel: the env or actor is outside its "
                    "envelope (kernel_fits)")
    obs, t0 = env_state.obs.contiguous(), env_state.t.contiguous()
    N, D = obs.shape
    M = env.num_costs
    dev = obs.device
    kernels.require(dev.type == generator.device.type == "cuda",
                    "rollout kernel: the env state and generator must be on "
                    "the card")
    f, i = torch.float32, torch.int32
    want = [(obs, f, (N, D)), (t0, i, (N,)), (stats.ep_reward, f, (N,)),
            (stats.ep_cost, f, (N, M)), (stats.ep_len, i, (N,)),
            (stats.sum_reward, f, ()), (stats.sum_cost, f, (M,)),
            (stats.sum_len, f, ())]
    want += [(getattr(stats, k), i, ()) for k in (
        "n_episodes", "n_steps", "n_terminated", "n_truncated")]
    want += [(x, f, (N,) + tuple(x.shape[1:])) for x in env_state.sim.values()]
    if actions is not None:
        want += [(actions[0], f, (T, N, A)), (actions[1], f, (T, N))]
    for x, dtype, shape in want:
        kernels.require(
            x.device == dev and x.dtype == dtype and tuple(x.shape) == shape,
            f"rollout kernel: expected a {dtype} tensor of shape {shape} on "
            f"{dev}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    noise, resets = segment_draws(env, T, N, generator)
    f32 = lambda *s: torch.empty(s, device=dev)
    i32 = lambda *s: torch.empty(s, dtype=torch.int32, device=dev)
    sim = {k: v.contiguous() for k, v in env_state.sim.items()}
    sim_o = {k: torch.empty_like(v) for k, v in sim.items()}
    # car: pos, heading, speed; ball: pos, vel
    sa, sb = ("heading", "speed") if "heading" in sim else ("vel", None)
    stats_o = EpisodeStats(**{k: torch.empty_like(v)
                              for k, v in vars(stats).items()})
    tr = Transition(obs=f32(T, N, D), act=f32(T, N, A), obs_next=f32(T, N, D),
                    reward=f32(T, N), cost=f32(T, N, M),
                    terminated=torch.empty((T, N), dtype=torch.bool,
                                           device=dev),
                    truncated=torch.empty((T, N), dtype=torch.bool,
                                          device=dev),
                    logp=f32(T, N))
    lib = kernels.library()
    kernels.require(
        (lib.fsrl_rollout_struct_bytes(0), lib.fsrl_rollout_struct_bytes(1))
        == (ctypes.sizeof(_Args), ctypes.sizeof(_Consts)),
        "rollout kernel: the argument structs differ from csrc/rollout.cu")
    layers = actor.trunk.layers
    hidden = layers[0].weight.shape[0]
    # one row of the episodes' sums a block (a cluster at 256)
    envs_a_row = tile(N, dev, hidden)
    rows = (N + envs_a_row - 1) // envs_a_row
    part_f, part_i = f32(rows, 2 + M), i32(rows)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    weights = [w.detach().contiguous() for w in (
        layers[0].weight, layers[0].bias, layers[1].weight, layers[1].bias,
        actor.mu.weight, actor.mu.bias, actor.log_sigma)]
    act_in, logp_in = (None, None) if actions is None else (
        actions[0].contiguous(), actions[1].contiguous())
    obs_o, t_o = f32(N, D), i32(N)
    ep_in = [x.contiguous() for x in (stats.ep_reward, stats.ep_cost,
                                      stats.ep_len)]
    ptr = lambda x: None if x is None else x.data_ptr()
    agg = dict(n_episodes="n_episodes", n_steps="n_steps",
               n_term="n_terminated", n_trunc="n_truncated",
               sum_r="sum_reward", sum_c="sum_cost", sum_l="sum_len")
    args = _Args(
        w1=ptr(weights[0]), b1=ptr(weights[1]), w2=ptr(weights[2]),
        b2=ptr(weights[3]), wmu=ptr(weights[4]), bmu=ptr(weights[5]),
        log_sigma=ptr(weights[6]), noise=ptr(noise), u0=ptr(resets[0]),
        u1=ptr(resets[1] if len(resets) > 1 else None), act_in=ptr(act_in),
        logp_in=ptr(logp_in), pos=ptr(sim["pos"]), sa=ptr(sim[sa]),
        sb=ptr(sim.get(sb)), obs=ptr(obs), t=ptr(t0),
        pos_o=ptr(sim_o["pos"]),
        sa_o=ptr(sim_o[sa]), sb_o=ptr(sim_o.get(sb)), obs_o=ptr(obs_o),
        t_o=ptr(t_o), ep_r=ptr(ep_in[0]), ep_c=ptr(ep_in[1]),
        ep_l=ptr(ep_in[2]), ep_r_o=ptr(stats_o.ep_reward),
        ep_c_o=ptr(stats_o.ep_cost), ep_l_o=ptr(stats_o.ep_len),
        **{k: ptr(getattr(stats, f)) for k, f in agg.items()},
        **{k + "_o": ptr(getattr(stats_o, f)) for k, f in agg.items()},
        tr_obs=ptr(tr.obs), tr_act=ptr(tr.act), tr_obs_next=ptr(tr.obs_next),
        tr_reward=ptr(tr.reward), tr_cost=ptr(tr.cost), tr_logp=ptr(tr.logp),
        tr_term=ptr(tr.terminated), tr_trunc=ptr(tr.truncated),
        part_f=ptr(part_f), part_i=ptr(part_i), counter=ptr(counter),
        T=T, N=N, D=D, M=M, max_steps=env.max_episode_steps,
        floored=actor.sigma_floor is not None)
    consts = _consts(env, actor)
    with torch.cuda.device(dev):
        rc = lib.fsrl_rollout(
            ctypes.byref(args), ctypes.byref(consts), kinds[0], kinds[1],
            hidden, envs_a_row, kernels.stream_ptr())
    kernels.check(rc, "rollout kernel")
    kernels.LAUNCHES["rollout"] += 1
    return EnvState(sim=sim_o, obs=obs_o, t=t_o), stats_o, tr
