"""TRPO-Lagrangian (port of ``fsrl_tpu/algos/trpo_lag.py``): a natural
gradient step on the combined (reward + lambda * cost, rescaled) surrogate.

Per update:

1. actor loss ``rescale * (-mean(ratio * advR) + sum_i lambda_i *
   mean(ratio * advC_i))`` on the whole batch;
2. search direction ``-CG(H_kl, grad)``, ``cg_iters`` iterations, with
   ``damping``; the Fisher-vector product is a double backward through the
   closed-form KL(old || new);
3. step size ``sqrt(2 * target_kl / s^T H s)``, then a backtracking line
   search that accepts ``kl < target_kl and loss_new < loss_old``: every
   candidate is evaluated and the first accepted one picked on the device;
   when all fail the smallest candidate step is applied;
4. critics: ``optim_critic_iters`` whole-batch Adam steps on the MSE.

Only the critics have an optimizer state. Actor and critic vectors are the
two halves of one flat parameter vector that the module's parameters view;
``update`` writes into it in place.

Data parallel (``update(..., dp=)``): each rank holds its block of the
batch; the advantages are normalized by the whole batch's statistics, and
the gradient, every Fisher-vector product, the line search's losses and KLs
and every critic step are summed over the ranks (weighted by their shares
of the rows) with one ``all_reduce`` each, so every rank takes the same
backtrack.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from fsrl_torch.algos.common import (ActorCriticAlgo, AdamState, Schedule,
                                     apply_flat, critic_steps, global_mean,
                                     lagrangian_step, make_optimizer,
                                     normalize_adv, process_rollout,
                                     split_flat)
from fsrl_torch.device import resolve_device
from fsrl_torch.nets.mlp import ActorCritic
from fsrl_torch.ops.cg import (backtrack_fractions, conjugate_gradient,
                               make_fvp)
from fsrl_torch.ops.lagrange import PIDLagrangianState
from fsrl_torch.types import Transition

Tensor = torch.Tensor


@dataclass
class TRPOLagState:
    params: ActorCritic      # its parameters are views of ``flat``
    flat: Tensor             # actor vector, then critic vector
    critic_opt_state: AdamState
    lag: PIDLagrangianState
    last_ep_cost: Tensor     # (M,)
    update_count: Tensor
    gradient_steps: Tensor


class TRPOLag(ActorCriticAlgo):
    """Config plus the init / act / update functions."""

    name = "trpo_lag"

    def __init__(self, obs_dim: int, act_dim: int, *,
                 cost_limit: float | list = 10.0, num_costs: int = 1,
                 hidden_sizes=(128, 128), lr: float | Schedule = 1e-3,
                 target_kl: float = 0.001, backtrack_coeff: float = 0.8,
                 max_backtracks: int = 10, optim_critic_iters: int = 20,
                 gae_lambda: float = 0.95,
                 advantage_normalization: bool = True,
                 use_lagrangian: bool = True, pid_filter: bool = True,
                 lagrangian_pid=(0.05, 0.0005, 0.1), rescaling: bool = True,
                 gamma: float = 0.99, unbounded: bool = False,
                 last_layer_scale: bool = True, max_action: float = 1.0,
                 cg_iters: int = 10, damping: float = 0.1, repeat: int = 1,
                 deterministic_eval: bool = True,
                 sigma_floor: float | None = None,
                 compute_dtype: torch.dtype | None = None,
                 episode_len: int | None = None, device=None):
        self.device = resolve_device(device)
        self.obs_dim, self.act_dim = obs_dim, act_dim
        self.num_costs = num_costs
        self.K = 1 + num_costs
        cl = ([cost_limit] * num_costs if isinstance(cost_limit, (int, float))
              else list(cost_limit))
        self.cost_limit = torch.tensor(cl, dtype=torch.float32,
                                       device=self.device)
        self.hp = dict(
            episode_len=episode_len, target_kl=target_kl,
            backtrack_coeff=backtrack_coeff, max_backtracks=max_backtracks,
            optim_critic_iters=optim_critic_iters, gae_lambda=gae_lambda,
            norm_adv=advantage_normalization, use_lagrangian=use_lagrangian,
            pid=tuple(lagrangian_pid), pid_filter=pid_filter,
            rescaling=rescaling, gamma=gamma, cg_iters=cg_iters,
            damping=damping, repeat=repeat)
        self.hidden_sizes = tuple(hidden_sizes)
        self.deterministic_eval = deterministic_eval
        self.net_kw = dict(max_action=max_action, unbounded=unbounded,
                           last_layer_scale=last_layer_scale,
                           sigma_floor=sigma_floor)
        self.compute_dtype = compute_dtype
        self.critic_tx = make_optimizer(lr)

    # ---------------- init ----------------
    def init(self, seed: int = 0, state_dict: dict | None = None
             ) -> TRPOLagState:
        """Fresh state; ``state_dict`` (e.g. from
        :func:`fsrl_torch.utils.params.from_jax_params`) sets the weights."""
        model, flat = self.init_model(seed, state_dict)
        dev = self.device
        return TRPOLagState(
            params=model, flat=flat,
            critic_opt_state=self.critic_tx.init(split_flat(model, flat)[1]),
            lag=PIDLagrangianState.init(self.num_costs, dev),
            last_ep_cost=torch.zeros(self.num_costs, device=dev),
            **self._counters())

    # ---------------- the trust-region step ----------------
    def _actor_loss(self, ratio: Tensor, adv: Tensor, lam_mult: Tensor,
                    resc: Tensor) -> Tensor:
        loss_rew = -(ratio * adv[:, 0]).mean()
        if self.hp["use_lagrangian"]:
            loss_safety = (lam_mult
                           * (ratio[:, None] * adv[:, 1:]).mean(0)).sum()
        else:
            loss_safety = 0.0
        return resc * (loss_rew + loss_safety)

    @torch.no_grad()
    def natural_gradient_step(self, model: ActorCritic, flat_a: Tensor,
                              obs: Tensor, act: Tensor, logp_old: Tensor,
                              adv: Tensor, lam_mult: Tensor, resc: Tensor,
                              reduce=None
                              ) -> tuple[Tensor, dict[str, Tensor], Tensor]:
        """One trust-region actor step on a batch from the actor vector
        ``flat_a``. Returns the new actor vector, the scalar diagnostics
        JAX's step returns, and the accepted candidate's index (a 0-d
        device tensor, outside the diagnostics, which JAX's lack it).
        ``reduce`` (data parallel, :func:`global_mean`) makes the rank's
        means over its rows global."""
        hp = self.hp
        glob = reduce or global_mean(None, 1.0)
        actor, names = model.actor, model.actor_names()
        old = apply_flat(actor, names, flat_a, obs)

        def dist_of(flat):
            return apply_flat(actor, names, flat, obs)

        def loss_of(dist):
            ratio = torch.exp(dist.log_prob(act) - logp_old)
            return self._actor_loss(ratio, adv, lam_mult, resc)

        def kl_of(dist):
            return old.kl(dist).mean()       # mean KL(old || new)

        with torch.enable_grad():
            f = flat_a.detach().requires_grad_(True)
            loss0 = loss_of(dist_of(f))
            (g,) = torch.autograd.grad(loss0, f)
        g, loss0 = glob(g, loss0.detach())
        fvp = make_fvp(lambda flat: kl_of(dist_of(flat)), flat_a,
                       hp["damping"], reduce)
        direction = -conjugate_gradient(fvp, g, hp["cg_iters"])
        shs = torch.dot(direction, fvp(direction))
        step_size = torch.sqrt(2 * hp["target_kl"]
                               / torch.clamp(shs, min=1e-12))

        fracs = backtrack_fractions(hp["backtrack_coeff"],
                                    hp["max_backtracks"], flat_a)
        kls, losses = [], []
        for frac in fracs:
            dist = dist_of(flat_a + frac * step_size * direction)
            kls.append(kl_of(dist))
            losses.append(loss_of(dist))
        kls, losses = glob(torch.stack(kls), torch.stack(losses))
        oks = (kls < hp["target_kl"]) & (losses < loss0)
        any_ok = oks.any()
        first = torch.argmax(oks.to(torch.int32))      # the first maximum
        # if every candidate fails, the smallest step is applied
        idx = torch.where(any_ok, first, hp["max_backtracks"] - 1)
        # an index tensor, not ``x[idx]``: a 0-d index is read on the host
        at = lambda x: x.index_select(0, idx.reshape(1))[0]
        frac = at(fracs)
        new_flat = flat_a + frac * step_size * direction
        info = dict(kl=at(kls), step_size=frac * step_size,
                    line_search_ok=any_ok.float(),
                    loss_actor_total=at(losses), loss_actor_old=loss0)
        return new_flat, info, idx

    # ---------------- update ----------------
    @torch.no_grad()
    def update(self, state: TRPOLagState, tr: Transition,
               ep_cost_mean: Tensor, n_episodes: Tensor,
               generator: torch.Generator | None = None,
               cost_limit: Tensor | None = None, dp=None
               ) -> tuple[TRPOLagState, dict[str, Tensor]]:
        """One whole-batch update; draws no random numbers. The accepted
        line-search index of each of its ``repeat`` steps is left in
        ``self.last_backtracks`` (a device tensor), not in the metrics,
        whose keys are JAX's. ``dp`` (a
        :class:`fsrl_torch.parallel.mesh.DPGroup`) makes ``tr`` this rank's
        block of the envs of a data-parallel update."""
        hp = self.hp
        model = state.params
        limit = self.cost_limit if cost_limit is None else cost_limit
        lag, cost_in, lam_mult, resc = lagrangian_step(
            hp, state, ep_cost_mean, n_episodes, limit)

        batch = process_rollout(model.critics, tr, hp["gamma"],
                                hp["gae_lambda"],
                                episode_len=hp["episode_len"], dp=dp)
        world = 1 if dp is None else dp.size
        reduce = None if dp is None else global_mean(dp, 1.0 / world)
        adv = (normalize_adv(batch.adv, dp=dp,
                             n_total=batch.adv.shape[0] * world)
               if hp["norm_adv"] else batch.adv)

        flat_a, flat_c = split_flat(model, state.flat)
        copt = state.critic_opt_state
        infos, accepted = [], []
        for _ in range(hp["repeat"]):
            new_flat, info, idx = self.natural_gradient_step(
                model, flat_a, batch.obs, batch.act, batch.logp_old, adv,
                lam_mult, resc, reduce)
            accepted.append(idx)
            flat_a.copy_(new_flat)
            copt, info["loss_vf_total"] = critic_steps(
                self.critic_tx, model.critics, model.critic_names(), flat_c,
                copt, batch.obs, batch.ret, hp["optim_critic_iters"],
                reduce=reduce)
            infos.append(info)

        self.last_backtracks = torch.stack(accepted)
        metrics = {f"loss/{k}": torch.stack([i[k] for i in infos]).mean()
                   for k in infos[0]}
        metrics["loss/rescaling"] = resc
        for i in range(self.num_costs):
            metrics[f"loss/lagrangian{'' if i == 0 else '_' + str(i)}"] = \
                lam_mult[i]

        new_state = TRPOLagState(
            params=model, flat=state.flat, critic_opt_state=copt, lag=lag,
            last_ep_cost=cost_in, update_count=state.update_count + 1,
            gradient_steps=state.gradient_steps
            + hp["repeat"] * hp["optim_critic_iters"])
        return new_state, metrics
