"""FOCOPS, First-Order Constrained Optimization in Policy Space (port of
``fsrl_tpu/algos/focops.py``; Zhang et al. 2020).

* scalar multiplier ``nu <- clip(nu - nu_lr * (cost_limit - avg_cost), 0,
  nu_max)``, stepped only on collects that finished an episode;
* actor loss ``mean[(KL(new || old) - (1 / tem_lambda) * ratio *
  (advR - nu * advC)) * 1[KL <= eta]]``; the indicator carries no gradient;
* per-minibatch advantage normalization over both channels;
* critics: Adam on the MSE plus L2 regularization over every critic
  parameter, each minibatch;
* two independent Adam states: the actor's with grad-norm clipping, the
  critics' without;
* the minibatches are redrawn every epoch (``minibatch_scan``: a fresh tile
  permutation and a fresh roll offset per epoch);
* KL early stop at ``delta`` after each epoch, kept on the device: after the
  stop, actor, critics and both Adam states (counts included) stay frozen
  while the remaining grad steps still run and report their metrics.

Actor and critic vectors are the two halves of one flat parameter vector
that the module's parameters view; ``update`` writes into it in place.

Data parallel (``update(..., dp=)``) as in PPO-Lag: each grad step takes the
rows of the global minibatch that the rank holds, and one ``all_reduce``
sums both gradients and the metrics over the ranks, weighted by their
shares of the rows (the critic loss's L2 term counts once, the shares
summing to 1). ``nu`` comes from the merged episode statistics and is the
same on every rank. ``dp_blocks`` is the block-local shuffle.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from fsrl_torch.algos.common import (ActorCriticAlgo, AdamState, Schedule,
                                     apply_flat, critic_loss_grad,
                                     make_optimizer, normalize_adv,
                                     process_rollout, reduce_step,
                                     select_state, split_flat)
from fsrl_torch.device import resolve_device
from fsrl_torch.nets.distributions import DiagGaussian
from fsrl_torch.nets.mlp import ActorCritic
from fsrl_torch.types import (TileLayout, Transition, draw_tile_perms,
                              is_epoch_end, minibatch_row_index, owned_rows)

Tensor = torch.Tensor


@dataclass
class FOCOPSState:
    params: ActorCritic      # its parameters are views of ``flat``
    flat: Tensor             # actor vector, then critic vector
    actor_opt_state: AdamState
    critic_opt_state: AdamState
    nu: Tensor               # () multiplier
    last_ep_cost: Tensor     # (1,)
    update_count: Tensor
    gradient_steps: Tensor


class FOCOPS(ActorCriticAlgo):
    """Config plus the init / act / update functions. Single constraint."""

    name = "focops"

    def __init__(self, obs_dim: int, act_dim: int, *,
                 cost_limit: float = 10.0, hidden_sizes=(128, 128),
                 actor_lr: float | Schedule = 3e-4,
                 critic_lr: float | Schedule = 3e-4, nu_max: float = 2.0,
                 nu_lr: float = 1e-2, nu_init: float = 0.01,
                 l2_reg: float = 1e-3, delta: float = 0.02,
                 eta: float = 0.02, tem_lambda: float = 0.95,
                 max_grad_norm: float | None = None,
                 gae_lambda: float = 0.95,
                 advantage_normalization: bool = True, gamma: float = 0.99,
                 unbounded: bool = False, last_layer_scale: bool = True,
                 max_action: float = 1.0, repeat: int = 4,
                 n_minibatches: int = 4, deterministic_eval: bool = True,
                 compute_dtype: torch.dtype | None = None,
                 episode_len: int | None = None, dp_blocks: int = 1,
                 device=None):
        self.device = resolve_device(device)
        self.obs_dim, self.act_dim = obs_dim, act_dim
        self.num_costs = 1
        self.K = 2
        self.cost_limit = float(cost_limit)
        self.hp = dict(
            episode_len=episode_len, nu_max=nu_max, nu_lr=nu_lr,
            l2_reg=l2_reg, delta=delta, eta=eta, tem_lambda=tem_lambda,
            gae_lambda=gae_lambda, norm_adv=advantage_normalization,
            gamma=gamma, repeat=repeat, n_minibatches=n_minibatches,
            dp_blocks=dp_blocks)
        self.nu_init = float(nu_init)
        self.hidden_sizes = tuple(hidden_sizes)
        self.deterministic_eval = deterministic_eval
        self.net_kw = dict(max_action=max_action, unbounded=unbounded,
                           last_layer_scale=last_layer_scale)
        self.compute_dtype = compute_dtype
        self.actor_tx = make_optimizer(actor_lr, max_grad_norm)
        self.critic_tx = make_optimizer(critic_lr)

    # ---------------- init ----------------
    def init(self, seed: int = 0, state_dict: dict | None = None
             ) -> FOCOPSState:
        """Fresh state; ``state_dict`` (e.g. from
        :func:`fsrl_torch.utils.params.from_jax_params`) sets the weights."""
        model, flat = self.init_model(seed, state_dict)
        flat_a, flat_c = split_flat(model, flat)
        dev = self.device
        return FOCOPSState(
            params=model, flat=flat,
            actor_opt_state=self.actor_tx.init(flat_a),
            critic_opt_state=self.critic_tx.init(flat_c),
            nu=torch.tensor(self.nu_init, device=dev),
            last_ep_cost=torch.zeros(1, device=dev), **self._counters())

    # ---------------- loss ----------------
    def _actor_loss_grad(self, model: ActorCritic, flat_a: Tensor, mb: dict,
                         nu: Tensor, adv: Tensor):
        """``(loss, mean KL(new || old), mean entropy, flat gradient)`` of
        the projection loss at the actor vector ``flat_a``, with ``adv``
        the minibatch's (normalized) advantages."""
        hp = self.hp
        with torch.enable_grad():
            f = flat_a.detach().requires_grad_(True)
            dist = apply_flat(model.actor, model.actor_names(), f, mb["obs"])
            ratio = torch.exp(dist.log_prob(mb["act"]) - mb["logp_old"])
            old = DiagGaussian(mb["mean_old"], mb["std_old"])
            kl_new_old = dist.kl(old)
            inner = kl_new_old - (1.0 / hp["tem_lambda"]) * ratio * (
                adv[:, 0] - nu * adv[:, 1])
            gate = (kl_new_old.detach() <= hp["eta"]).to(inner.dtype)
            loss = (inner * gate).mean()
            (grad,) = torch.autograd.grad(loss, f)
        return (loss.detach(), kl_new_old.detach().mean(),
                dist.entropy().detach().mean(), grad)

    # ---------------- update ----------------
    @torch.no_grad()
    def update(self, state: FOCOPSState, tr: Transition,
               ep_cost_mean: Tensor, n_episodes: Tensor,
               generator: torch.Generator,
               cost_limit: Tensor | None = None,
               perms: tuple[Tensor, Tensor] | None = None, dp=None
               ) -> tuple[FOCOPSState, dict[str, Tensor]]:
        """One whole-segment update. ``perms`` = ``(tile permutations
        (repeat, usable) or (repeat, dp_blocks, usable), roll offsets
        (repeat,))`` replaces the shuffle draw (the parity tests pass the
        ones JAX draws). ``dp`` (a
        :class:`fsrl_torch.parallel.mesh.DPGroup`) makes ``tr`` this rank's
        block of the envs of a data-parallel update."""
        hp = self.hp
        dev = self.device
        model = state.params
        fresh = n_episodes > 0
        last_ep_cost = torch.where(fresh, ep_cost_mean, state.last_ep_cost)
        limit = self.cost_limit if cost_limit is None \
            else cost_limit.reshape(())
        loss_nu = limit - last_ep_cost[0]
        nu_new = torch.clamp(state.nu - hp["nu_lr"] * loss_nu, 0.0,
                             hp["nu_max"])
        nu = torch.where(fresh, nu_new, state.nu)

        batch = process_rollout(model.critics, tr, hp["gamma"],
                                hp["gae_lambda"],
                                episode_len=hp["episode_len"], dp=dp)
        old_dist = model.actor(batch.obs)
        full = dict(obs=batch.obs, act=batch.act, logp_old=batch.logp_old,
                    adv=batch.adv, ret=batch.ret, mean_old=old_dist.mean,
                    std_old=old_dist.std)

        n_mb, repeat = hp["n_minibatches"], hp["repeat"]
        n_local = batch.obs.shape[0]
        world = 1 if dp is None else dp.size
        layout = TileLayout.of(n_local * world, n_mb,
                               n_blocks=hp["dp_blocks"])
        if perms is None:
            perms = draw_tile_perms(layout, repeat, generator, dev,
                                    roll_per_epoch=True)
        rows = minibatch_row_index(layout, *perms)     # (repeat*n_mb, rows)
        if dp is None:
            # one gather per field for all grad steps
            mbs = {k: v[rows] for k, v in full.items()}
            step_rows = [None] * rows.shape[0]
        else:
            lo = dp.rank * n_local
            step_rows, counts = owned_rows(rows, lo, lo + n_local)

        flat_a, flat_c = split_flat(model, state.flat)
        aopt, copt = state.actor_opt_state, state.critic_opt_state
        critic_names = model.critic_names()
        stopped = torch.zeros((), dtype=torch.bool, device=dev)
        gsteps = state.gradient_steps
        kl_acc = torch.zeros((), device=dev)
        auxes = []
        for s, idx in enumerate(step_rows):
            if dp is None:
                mb = {k: v[s] for k, v in mbs.items()}
            else:
                mb = {k: v[idx] for k, v in full.items()}
            adv = (normalize_adv(mb["adv"], dp=dp, n_total=layout.mb_rows)
                   if hp["norm_adv"] else mb["adv"])
            if dp is not None and counts[s] == 0:
                # no rows here: this rank adds zeros to the sums
                closs = aloss = kl = ent = torch.zeros((), device=dev)
                cgrad, agrad = torch.zeros_like(flat_c), torch.zeros_like(
                    flat_a)
            else:
                closs, cgrad = critic_loss_grad(
                    model.critics, critic_names, flat_c, mb["obs"],
                    mb["ret"], hp["l2_reg"])
                aloss, kl, ent, agrad = self._actor_loss_grad(
                    model, flat_a, mb, nu, adv)
            aux = dict(actor_loss=aloss, vf_total=closs, kl=kl, entropy=ent)
            if dp is not None:
                (cgrad, agrad), aux = reduce_step(
                    dp, counts[s] / layout.mb_rows, [cgrad, agrad], aux)
            cupd, new_copt = self.critic_tx.update(cgrad, copt)
            aupd, new_aopt = self.actor_tx.update(agrad, aopt)
            flat_c.copy_(torch.where(stopped, flat_c, flat_c + cupd))
            flat_a.copy_(torch.where(stopped, flat_a, flat_a + aupd))
            copt = select_state(stopped, copt, new_copt)
            aopt = select_state(stopped, aopt, new_aopt)
            gsteps = gsteps + (~stopped).to(gsteps.dtype)
            kl_acc = kl_acc + aux["kl"]
            if is_epoch_end(s, n_mb):
                stopped = stopped | (kl_acc / n_mb > hp["delta"])
                kl_acc = torch.zeros_like(kl_acc)
            auxes.append(aux)

        metrics = {f"loss/{k}": torch.stack([a[k] for a in auxes]).mean()
                   for k in auxes[0]}
        metrics["loss/nu_value"] = nu
        metrics["loss/nu_loss"] = loss_nu
        metrics["update/early_stopped"] = stopped.float()

        new_state = FOCOPSState(
            params=model, flat=state.flat, actor_opt_state=aopt,
            critic_opt_state=copt, nu=nu, last_ep_cost=last_ep_cost,
            update_count=state.update_count + 1, gradient_steps=gsteps)
        return new_state, metrics
