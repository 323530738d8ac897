"""Shared algorithm plumbing (port of ``fsrl_tpu/algos/common.py``): rollout
processing with GAE over the stacked (reward, cost) channels, advantage
normalization, the flat Adam optimizer (also the plain Adam of the
off-policy duals and temperature) and the Polyak ``soft_update``.

All (1 + M) metric channels are processed jointly on a trailing axis
K = 1 + M: column 0 is the reward, columns 1..M the costs.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Callable

import torch
from torch import nn
from torch.func import functional_call

from fsrl_torch.nets.mlp import ActorCritic, GaussianActor, VCriticEnsemble
from fsrl_torch.ops.gae_kernel import gae_advantages_fused
from fsrl_torch.ops.lagrange import pid_controller_step, rescaling_factor
from fsrl_torch.types import Transition
from fsrl_torch.utils.params import flatten_parameters_, unflatten

Tensor = torch.Tensor
# lr(step count) -> learning rate; the count is an int or a 0-d int tensor
Schedule = Callable[["Tensor | int"], "Tensor | float"]


@dataclass
class OnPolicyBatch:
    """Flattened (B = N*T, env-major) processed batch."""

    obs: Tensor        # (B, obs_dim)
    act: Tensor        # (B, act_dim)
    logp_old: Tensor   # (B,)
    adv: Tensor        # (B, K)
    ret: Tensor        # (B, K)
    value_old: Tensor  # (B, K)


def metrics_of(tr: Transition) -> Tensor:
    """Stack the reward and cost channels: (T, N, K)."""
    return torch.cat([tr.reward[..., None], tr.cost], -1)


def _bootstrap_values(critic_apply: Callable[[Tensor], Tensor],
                      tr: Transition, values_next: Tensor, n_boot: int,
                      dp=None) -> Tensor:
    """``values_next`` (``v(obs[t+1])``, ``(T, N, K)``) with the value of the
    true next observation at the truncated rows, where ``obs[t+1]`` is the
    next episode's first. Those rows' values come from one critic call
    over ``n_boot`` rows: the truncated rows in time-major flat order,
    those past ``n_boot`` dropped (JAX's ``nonzero(size=...)`` and
    ``.at[].set(mode="drop")``), the rest zero. Under data parallelism
    (``dp``) the gather spans every rank's envs, two ``all_reduce`` (the
    truncations a step, then the rows), so each row has the place and the
    batch it has in one process, and its value rounds alike. No host
    sync."""
    T, N = tr.reward.shape
    W, r = (1, 0) if dp is None else (dp.size, dp.rank)
    trunc = tr.truncated & ~tr.terminated                        # (T, N)
    per = values_next.new_zeros(T, W)
    per[:, r] = trunc.sum(1, dtype=per.dtype)
    if dp is not None:
        (per,) = dp.all_sum(per)
    # truncations before this rank's block of each step, in flat order
    before = (torch.cumsum(per.reshape(-1), 0) - per.reshape(-1)).view(T, W)
    pos = before[:, r:r + 1].long() + torch.cumsum(trunc.long(), 1) - 1
    take = trunc & (pos < n_boot)
    slot = torch.where(take, pos, n_boot).reshape(-1)
    d = tr.obs_next.shape[2:]
    # one spare row takes the rows not taken
    rows = tr.obs_next.new_zeros((n_boot + 1,) + d)
    rows.index_copy_(0, slot, tr.obs_next.reshape((T * N,) + d))
    rows = rows[:-1]
    if dp is not None:
        (rows,) = dp.all_sum(rows)
    v = critic_apply(rows)
    v = torch.cat([v, v.new_zeros(1, v.shape[-1])])[slot]
    return torch.where(take.reshape(-1, 1), v,
                       values_next.reshape(T * N, -1)).view(values_next.shape)


@torch.no_grad()
def process_rollout(critic_apply: Callable[[Tensor], Tensor], tr: Transition,
                    gamma: float, lam: float, ret_rms=None,
                    episode_len: int | None = None, dp=None):
    """GAE over the rollout segment, through kernel K1 on the card.

    * bootstrap mask: ``v(s') = 0`` where terminated;
    * the lambda-chain breaks at done steps.

    By default the critic runs over ``obs`` and ``obs_next`` (two passes).
    With ``episode_len`` (the env's truncation horizon) one pass over the
    ``T + 1`` rows ``obs[0..T-1], obs_next[T-1]`` gives every ``v(obs_next)``
    except at truncations, which are at most ``T // episode_len + 1`` per
    env; those rows get one small gather, forward and scatter
    (:func:`_bootstrap_values`).

    Returns the env-major flattened :class:`OnPolicyBatch`, and the updated
    return statistics when ``ret_rms`` is given. Under data parallelism
    (``dp``, a :class:`fsrl_torch.parallel.mesh.DPGroup`) ``tr`` holds the
    rank's block of envs: GAE is per env and needs nothing from the other
    ranks, the truncated rows' gather spans them, the return statistics
    merge over them, and the env-major flatten keeps the rank's rows
    together, rows ``[r*n, (r+1)*n)`` of the global batch."""
    T, N = tr.reward.shape
    m = metrics_of(tr)
    if episode_len is not None and T > 2:
        n_boot = N * (T // int(episode_len) + 1)
        if dp is not None:
            n_boot *= dp.size
        ext = torch.cat([tr.obs, tr.obs_next[-1:]], 0)        # (T+1, N, d)
        values_ext = critic_apply(ext)                        # (T+1, N, K)
        values = values_ext[:-1]
        values_next = _bootstrap_values(critic_apply, tr,
                                        values_ext[1:].contiguous(), n_boot,
                                        dp)
    else:
        values = critic_apply(tr.obs)
        values_next = critic_apply(tr.obs_next)
    mask = (~tr.terminated).to(values.dtype)[..., None]
    values_next = values_next * mask
    end_flag = (tr.terminated | tr.truncated).contiguous()

    if ret_rms is not None:
        # critics learn scale-normalized returns: unscale their outputs for
        # GAE, then re-normalize the new returns and update the statistics
        scale = torch.sqrt(ret_rms.var + 1e-8)
        adv, ret = gae_advantages_fused(
            m.contiguous(), (values * scale).contiguous(),
            (values_next * scale).contiguous(), end_flag, gamma, lam)
        ret = ret / scale
        new_rms = ret_rms.update(ret.reshape(T * N, -1), dp)
    else:
        adv, ret = gae_advantages_fused(
            m.contiguous(), values.contiguous(), values_next.contiguous(),
            end_flag, gamma, lam)
        new_rms = None

    # env-major flatten: (T, N, ...) -> (N*T, ...), each env's rows together
    flat = lambda x: x.transpose(0, 1).reshape((N * T,) + x.shape[2:])
    batch = OnPolicyBatch(obs=flat(tr.obs), act=flat(tr.act),
                          logp_old=flat(tr.logp), adv=flat(adv),
                          ret=flat(ret), value_old=flat(values))
    return (batch, new_rms) if ret_rms is not None else batch


def lagrangian_step(hp: dict, state, ep_cost_mean: Tensor,
                    n_episodes: Tensor, limit: Tensor):
    """The collect's PID multiplier step (the Lagrangian algorithms'
    ``update`` head): ``(lag, cost_in, multiplier, rescale)``. ``cost_in``
    is the cost measurement the state keeps (the filtered one, or without
    the Lagrangian the last collect's that finished episodes); the rescale
    is ``1 / (sum lambda + 1)`` where ``hp["rescaling"]``, 1 without the
    Lagrangian."""
    if hp["use_lagrangian"]:
        kp, ki, kd = hp["pid"]
        lag = pid_controller_step(
            state.lag, ep_cost_mean, n_episodes, limit, kp, ki, kd,
            filtered=hp["pid_filter"], horizon=40.0)
        return (lag, lag.cost_ema, lag.multiplier,
                rescaling_factor(lag.multiplier, hp["rescaling"]))
    cost_in = torch.where(n_episodes > 0, ep_cost_mean, state.last_ep_cost)
    return (state.lag, cost_in, state.lag.multiplier,
            torch.ones((), device=ep_cost_mean.device))


def ppo_metrics(auxes: list[dict], resc: Tensor, lam_mult: Tensor,
                stopped: Tensor) -> dict[str, Tensor]:
    """The PPO-Lag metric dict, JAX's names: each grad step's losses
    averaged over the update, the rescale, each multiplier and the early
    stop flag."""
    metrics = {
        ("loss/" + k if not k.startswith("loss") else
         k.replace("_", "/", 1)): torch.stack([a[k] for a in auxes]).mean()
        for k in auxes[0]}
    metrics["loss/rescaling"] = resc
    for i in range(lam_mult.shape[0]):
        metrics[f"loss/lagrangian{'' if i == 0 else '_' + str(i)}"] = \
            lam_mult[i]
    metrics["update/early_stopped"] = stopped.float()
    return metrics


def normalize_adv(adv: Tensor, eps: float = 1e-8, dp=None,
                  n_total: int | None = None) -> Tensor:
    """Per-batch, per-channel advantage normalization (cost channels too).
    With ``dp`` (a :class:`fsrl_torch.parallel.mesh.DPGroup`) ``adv`` is
    the rank's rows (any number, none included) of a batch of ``n_total``
    rows, normalized by the whole batch's mean and standard deviation: one
    ``all_reduce`` of the sum and the sum of squares. Both are taken in
    float64, so the mean and the deviation round to the same float32
    values however many ranks summed them."""
    a = adv.double()
    s, sq = a.sum(0, keepdim=True), (a * a).sum(0, keepdim=True)
    if dp is not None:
        s, sq = dp.all_sum(s, sq)
    n = adv.shape[0] if dp is None else n_total
    mean = s / n
    std = torch.sqrt(torch.clamp(sq / n - mean * mean, min=0.0))
    return (adv - mean.to(adv.dtype)) / (std.to(adv.dtype) + eps)


def global_mean(dp, weight: float) -> Callable[..., list[Tensor]]:
    """``fn(*tensors)``: the global means of per-rank means, the weighted
    ``all_reduce`` of :meth:`DPGroup.weighted_sum` with ``weight = n_r /
    n``; without ``dp`` the tensors themselves."""
    if dp is None:
        return lambda *ts: list(ts)
    return lambda *ts: dp.weighted_sum(weight, *ts)


def reduce_step(dp, weight: float, grads: list[Tensor],
                scalars: dict[str, Tensor]
                ) -> tuple[list[Tensor], dict[str, Tensor]]:
    """The global mean of a grad step's flat gradients and scalar metrics,
    each a mean over the rank's rows, in one ``all_reduce``: the weighted
    sum over ranks with ``weight = n_r / n``. Identity without ``dp``."""
    if dp is None:
        return grads, scalars
    names = list(scalars)
    out = dp.weighted_sum(weight, *grads,
                          *(scalars[k].float().reshape(()) for k in names))
    return out[: len(grads)], dict(zip(names, out[len(grads):]))


@dataclass
class AdamState:
    count: Tensor   # () int32
    mu: Tensor      # flat first moment
    nu: Tensor      # flat second moment


class FlatAdam:
    """``optax.chain(clip_by_global_norm(max_grad_norm), adam(lr))`` on one
    flat parameter vector (``make_optimizer(..., flat=True)``), with optax's
    operation order. ``lr`` is a float or a schedule: a callable of the
    step count, evaluated on the device at the count before the step's
    increment, as optax's ``scale_by_schedule`` does."""

    def __init__(self, lr: float | Schedule,
                 max_grad_norm: float | None = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.max_grad_norm = lr, max_grad_norm
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, flat: Tensor) -> AdamState:
        return AdamState(count=torch.zeros((), dtype=torch.int32,
                                           device=flat.device),
                         mu=torch.zeros_like(flat), nu=torch.zeros_like(flat))

    def update(self, grad: Tensor, state: AdamState
               ) -> tuple[Tensor, AdamState]:
        """Returns ``(updates, new_state)``; apply as ``params + updates``."""
        if self.max_grad_norm is not None:
            g_norm = torch.sqrt(torch.sum(grad * grad))
            grad = torch.where(g_norm < self.max_grad_norm, grad,
                               (grad / g_norm) * self.max_grad_norm)
        b1, b2 = self.b1, self.b2
        mu = (1 - b1) * grad + b1 * state.mu
        nu = (1 - b2) * (grad * grad) + b2 * state.nu
        count = state.count + 1
        c = count.to(grad.dtype)
        mu_hat = mu / (1 - b1 ** c)
        nu_hat = nu / (1 - b2 ** c)
        lr = self.lr(state.count) if callable(self.lr) else self.lr
        updates = -lr * (mu_hat / (torch.sqrt(nu_hat) + self.eps))
        return updates, AdamState(count=count, mu=mu, nu=nu)


def make_optimizer(lr: float | Schedule,
                   max_grad_norm: float | None = None) -> FlatAdam:
    """Adam with optional global-norm clipping, on one flat vector. ``lr``
    may be a schedule; it advances once per gradient step (use
    :func:`per_update_schedule` for a schedule in trainer-update units)."""
    return FlatAdam(lr, max_grad_norm)


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    """``optax.linear_schedule``: from ``init_value`` to ``end_value`` over
    ``transition_steps`` counts, constant after. Takes an int or an integer
    tensor and returns a float32 tensor on the count's device."""
    def sched(count):
        c = torch.clamp(torch.as_tensor(count), 0, transition_steps)
        frac = 1.0 - c.to(torch.float32) / transition_steps
        return (init_value - end_value) * frac + end_value
    return sched


def per_update_schedule(schedule: Schedule,
                        grad_steps_per_update: int) -> Schedule:
    """Adapt a schedule in trainer-update units to the per-gradient-step
    count: ``lr(t) = schedule(t // grad_steps_per_update)``. For on-policy
    algorithms ``grad_steps_per_update = repeat * n_minibatches``."""
    def sched(count):
        return schedule(count // grad_steps_per_update)
    return sched


def select_state(stopped: Tensor, old: AdamState, new: AdamState) -> AdamState:
    """``old`` where ``stopped`` (a 0-d bool tensor) else ``new``, field by
    field: the masked optimizer step after a KL early stop."""
    return AdamState(*(torch.where(stopped, getattr(old, f.name),
                                   getattr(new, f.name))
                       for f in fields(AdamState)))


class ActorCriticAlgo:
    """What the on-policy algorithms share: the Gaussian actor and V-critic
    ensemble behind one flat parameter vector, and acting. A subclass sets
    ``device``, ``obs_dim``, ``act_dim``, ``K``, ``hidden_sizes``,
    ``compute_dtype``, ``net_kw`` (the actor's keywords) and
    ``deterministic_eval``."""

    def make_params(self, seed: int = 0) -> ActorCritic:
        """Orthogonal init from a seeded CPU generator, then moved to the
        algorithm's device."""
        g = torch.Generator().manual_seed(seed)
        actor = GaussianActor(self.obs_dim, self.act_dim, self.hidden_sizes,
                              compute_dtype=self.compute_dtype, generator=g,
                              **self.net_kw)
        critics = VCriticEnsemble(self.obs_dim, self.K, self.hidden_sizes,
                                  compute_dtype=self.compute_dtype,
                                  generator=g)
        return ActorCritic(actor, critics).to(self.device)

    def init_model(self, seed: int = 0, state_dict: dict | None = None
                   ) -> tuple[ActorCritic, Tensor]:
        """The model and the flat vector its parameters view (actor first);
        ``state_dict`` (e.g. from
        :func:`fsrl_torch.utils.params.from_jax_params`) sets the weights."""
        model = self.make_params(seed)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        return model, flatten_parameters_(model, model.flat_names())

    def _counters(self) -> dict[str, Tensor]:
        z = lambda: torch.zeros((), dtype=torch.int32, device=self.device)
        return dict(update_count=z(), gradient_steps=z())

    @torch.no_grad()
    def act_fn(self, params: ActorCritic, obs: Tensor,
               generator: torch.Generator):
        dist = params.actor(obs)
        act = dist.sample(generator)
        return act, dist.log_prob(act)

    @torch.no_grad()
    def act_fn_eval(self, params: ActorCritic, obs: Tensor,
                    generator: torch.Generator):
        dist = params.actor(obs)
        act = dist.mode() if self.deterministic_eval else dist.sample(
            generator)
        return act, dist.log_prob(act)


# ---------------------------------------------------------------------------
# Separate actor and critic vectors (FOCOPS, TRPO-Lag, CPO): the actor's
# parameters come first in ``ActorCritic.flat_names``, so both are contiguous
# views of the one flat vector the module's parameters view.
# ---------------------------------------------------------------------------

def split_flat(model: nn.Module, flat: Tensor) -> tuple[Tensor, Tensor]:
    """``(actor vector, critic vector)``, views of ``flat``."""
    n_actor = sum(p.numel() for p in model.actor.parameters())
    return flat[:n_actor], flat[n_actor:]


def apply_flat(module: nn.Module, names: list[str], flat: Tensor, *args):
    """``module(*args)`` with its parameters read from ``flat`` (in
    ``names`` order): differentiable with respect to ``flat``."""
    return functional_call(module, unflatten(flat, module, names), args)


def critic_loss_grad(critics: nn.Module, names: list[str], flat_c: Tensor,
                     obs: Tensor, ret: Tensor,
                     l2_reg: float = 0.0) -> tuple[Tensor, Tensor]:
    """The critic ensemble's loss ``sum_k mean_b (ret - v)^2`` plus
    ``l2_reg`` times the squared norm of every critic parameter (biases
    included), and its gradient at ``flat_c``. Both are linear in the
    row means, so a weighted sum over data-parallel ranks whose weights sum
    to 1 gives the global ones."""
    with torch.enable_grad():
        f = flat_c.detach().requires_grad_(True)
        v = apply_flat(critics, names, f, obs)
        loss = ((ret - v) ** 2).mean(0).sum()
        if l2_reg:
            loss = loss + l2_reg * (f * f).sum()
        (grad,) = torch.autograd.grad(loss, f)
    return loss.detach(), grad


def critic_steps(tx: FlatAdam, critics: nn.Module, names: list[str],
                 flat_c: Tensor, opt: AdamState, obs: Tensor, ret: Tensor,
                 n_iters: int, l2_reg: float = 0.0,
                 reduce: Callable[..., list[Tensor]] | None = None
                 ) -> tuple[AdamState, Tensor]:
    """``n_iters`` whole-batch Adam steps on the critic loss, written into
    ``flat_c`` in place. Returns the optimizer state and the last step's
    loss (taken before that step). ``reduce`` (data parallel,
    :func:`global_mean`) makes each step's gradient and loss global."""
    loss = None
    for _ in range(n_iters):
        loss, grad = critic_loss_grad(critics, names, flat_c, obs, ret,
                                      l2_reg)
        if reduce is not None:
            grad, loss = reduce(grad, loss)
        updates, opt = tx.update(grad, opt)
        flat_c.add_(updates)
    return opt, loss


@torch.no_grad()
def soft_update(target: Tensor, online: Tensor, tau: float) -> None:
    """Polyak averaging of a target vector in place, written as JAX writes
    it, ``(1 - tau) * target + tau * online`` (``torch.lerp`` rounds
    otherwise)."""
    torch.add((1.0 - tau) * target, tau * online, out=target)
