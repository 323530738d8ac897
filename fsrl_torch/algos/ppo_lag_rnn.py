"""Recurrent PPO-Lagrangian (port of ``fsrl_tpu/algos/ppo_lag_rnn.py``):
truncated BPTT for partially observable safe RL.

* The actor is a GRU (:class:`fsrl_torch.nets.mlp.RecurrentGaussianActor`);
  the (1 + M) critics stay the feedforward ensemble on observations.
* GAE over the whole segment runs through kernel K1 on the card (JAX runs
  ``gae_advantages_pscan`` here, whose multiply-adds XLA contracts into
  FMAs; K1 rounds twice, a few 1e-6 apart).
* Minibatches are drawn over the env axis, so whole T-step sequences stay
  together: the GRU is unrolled again from the carry at the start of the
  segment, its hidden state zeroed after every done step as the collector
  does, and autograd takes the gradient through the whole unroll.
* Everything else is PPO-Lag's: clipped surrogate plus the PID-Lagrangian
  safety term with the ``1 / (sum lambda + 1)`` rescale, joint Adam on one
  flat vector with grad-norm clipping, and the KL early stop at each epoch's
  end kept on the device (frozen parameters and optimizer state after it).
* Data parallel (``update(..., dp=)``): the segment and the carry are the
  rank's block of envs; each minibatch takes the envs of the global
  minibatch that the rank holds, and its gradient and metrics are summed
  over the ranks, weighted by their shares of the envs, in one
  ``all_reduce``, as in PPO-Lag.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.func import functional_call

from fsrl_torch.algos.common import (AdamState, Schedule, lagrangian_step,
                                     make_optimizer, metrics_of,
                                     normalize_adv, ppo_metrics, reduce_step,
                                     select_state)
from fsrl_torch.algos.ppo_lag import AUX_NAMES
from fsrl_torch.device import resolve_device
from fsrl_torch.nets.distributions import DiagGaussian
from fsrl_torch.nets.mlp import (RecurrentActorCritic, RecurrentGaussianActor,
                                 VCriticEnsemble, gru_step)
from fsrl_torch.ops.gae_kernel import gae_advantages_fused
from fsrl_torch.ops.lagrange import PIDLagrangianState
from fsrl_torch.types import Transition, is_epoch_end, owned_rows
from fsrl_torch.utils.params import flatten_parameters_, unflatten

Tensor = torch.Tensor


@dataclass
class RecurrentPPOLagState:
    params: RecurrentActorCritic   # its parameters are views of ``flat``
    flat: Tensor
    opt_state: AdamState
    lag: PIDLagrangianState
    last_ep_cost: Tensor           # (M,)
    update_count: Tensor
    gradient_steps: Tensor


class RecurrentPPOLag:
    """GRU actor and feedforward critic ensemble trained with truncated
    BPTT over collected segments. The API is :class:`PPOLag`'s, except that
    ``act_fn`` carries a hidden state and ``update`` takes the carry at the
    start of the segment (``RolloutResult.init_hidden``)."""

    name = "ppo_lag_rnn"

    def __init__(self, obs_dim: int, act_dim: int, *,
                 cost_limit: float | list = 10.0, num_costs: int = 1,
                 hidden_size: int = 128, critic_hidden_sizes=(128, 128),
                 lr: float | Schedule = 5e-4, target_kl: float = 0.02,
                 vf_coef: float = 0.25, max_grad_norm: float | None = 0.5,
                 gae_lambda: float = 0.95, eps_clip: float = 0.2,
                 advantage_normalization: bool = True,
                 use_lagrangian: bool = True, pid_filter: bool = True,
                 lagrangian_pid=(0.05, 0.0005, 0.1), rescaling: bool = True,
                 gamma: float = 0.99, max_action: float = 1.0,
                 repeat: int = 4, n_minibatches: int = 4,
                 deterministic_eval: bool = True,
                 compute_dtype: torch.dtype | None = None, device=None):
        self.device = resolve_device(device)
        self.obs_dim, self.act_dim = obs_dim, act_dim
        self.num_costs = num_costs
        self.K = 1 + num_costs
        cl = ([cost_limit] * num_costs if isinstance(cost_limit, (int, float))
              else list(cost_limit))
        self.cost_limit = torch.tensor(cl, dtype=torch.float32,
                                       device=self.device)
        self.hidden_size = hidden_size
        self.critic_hidden_sizes = tuple(critic_hidden_sizes)
        self.hp = dict(
            lr=lr, target_kl=target_kl, vf_coef=vf_coef,
            max_grad_norm=max_grad_norm, gae_lambda=gae_lambda,
            eps_clip=eps_clip, norm_adv=advantage_normalization,
            use_lagrangian=use_lagrangian, pid=tuple(lagrangian_pid),
            pid_filter=pid_filter, rescaling=rescaling, gamma=gamma,
            repeat=repeat, n_minibatches=n_minibatches)
        self.max_action = max_action
        self.deterministic_eval = deterministic_eval
        # bf16 critic trunks; the GRU stays float32, as in JAX
        self.compute_dtype = compute_dtype
        self.tx = make_optimizer(lr, max_grad_norm)

    # ---------------- init ----------------
    def init(self, seed: int = 0, state_dict: dict | None = None
             ) -> RecurrentPPOLagState:
        """Fresh state; ``state_dict`` (e.g. from
        :func:`fsrl_torch.utils.params.from_jax_params`) sets the weights."""
        g = torch.Generator().manual_seed(seed)
        actor = RecurrentGaussianActor(self.obs_dim, self.act_dim,
                                       self.hidden_size, self.max_action, g)
        critics = VCriticEnsemble(self.obs_dim, self.K,
                                  self.critic_hidden_sizes,
                                  compute_dtype=self.compute_dtype,
                                  generator=g)
        model = RecurrentActorCritic(actor, critics).to(self.device)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        flat = flatten_parameters_(model, model.flat_names())
        dev = self.device
        z = lambda: torch.zeros((), dtype=torch.int32, device=dev)
        return RecurrentPPOLagState(
            params=model, flat=flat, opt_state=self.tx.init(flat),
            lag=PIDLagrangianState.init(self.num_costs, dev),
            last_ep_cost=torch.zeros(self.num_costs, device=dev),
            update_count=z(), gradient_steps=z())

    def init_hidden(self, n_envs: int) -> Tensor:
        return torch.zeros(n_envs, self.hidden_size, device=self.device)

    # ---------------- acting (recurrent signature) ----------------
    @torch.no_grad()
    def act_fn(self, params: RecurrentActorCritic, obs: Tensor,
               hidden: Tensor, generator: torch.Generator):
        dist, hidden = params.actor(obs, hidden)
        act = dist.sample(generator)
        return act, dist.log_prob(act), hidden

    @torch.no_grad()
    def act_fn_eval(self, params: RecurrentActorCritic, obs: Tensor,
                    hidden: Tensor, generator: torch.Generator):
        dist, hidden = params.actor(obs, hidden)
        act = dist.mode() if self.deterministic_eval else dist.sample(
            generator)
        return act, dist.log_prob(act), hidden

    # ---------------- update (truncated BPTT) ----------------
    def unroll(self, views: dict[str, Tensor], obs: Tensor, done: Tensor,
               h0: Tensor) -> DiagGaussian:
        """The GRU over a (T, n) block of sequences from the carry ``h0``
        (n, H), with the collector's reset: the hidden state is zeroed after
        a done step. ``views`` are the actor's weights by name (within the
        actor). Returns the (T, n, A) action distributions."""
        h, means = h0, []
        for t in range(obs.shape[0]):
            h = gru_step(obs[t], h, views["cell.weight_ih"],
                         views["cell.weight_hh"], views["cell.bias_ih"],
                         views["cell.bias_hn"])
            means.append(self.max_action * torch.tanh(
                h @ views["mu.weight"].T + views["mu.bias"]))
            h = torch.where(done[t][:, None], torch.zeros_like(h), h)
        mean = torch.stack(means)
        return DiagGaussian(mean=mean, std=torch.exp(
            views["log_sigma"]).expand(mean.shape))

    def _loss_grad(self, state: RecurrentPPOLagState, mb: dict,
                   lam_mult: Tensor, resc: Tensor, adv: Tensor):
        """Loss, metrics and flat gradient of one minibatch of whole
        sequences, by autograd through the unroll; ``adv`` holds the
        (normalized) advantages of its ``T * n`` rows."""
        hp = self.hp
        model = state.params
        with torch.enable_grad():
            f = state.flat.detach().requires_grad_(True)
            views = unflatten(f, model, model.flat_names())
            actor = {k[len("actor."):]: v for k, v in views.items()
                     if k.startswith("actor.")}
            critic = {k[len("critics."):]: v for k, v in views.items()
                      if k.startswith("critics.")}
            dist = self.unroll(actor, mb["obs"], mb["done"], mb["h0"])
            log_p = dist.log_prob(mb["act"])                 # (T, n)
            ratio = torch.exp(log_p - mb["logp_old"])
            ratio_f = ratio.reshape(-1)
            rew_adv = adv[:, 0]
            eps = hp["eps_clip"]
            surr1 = ratio_f * rew_adv
            # minimum(maximum(.)) splits the gradient at the bounds as
            # jnp.clip does
            surr2 = torch.minimum(torch.maximum(
                ratio_f, torch.full_like(ratio_f, 1 - eps)),
                torch.full_like(ratio_f, 1 + eps)) * rew_adv
            loss_rew = -torch.minimum(surr1, surr2).mean()
            if hp["use_lagrangian"]:
                cost_terms = (ratio_f[:, None] * adv[:, 1:]).mean(0)
                loss_safety = (lam_mult * cost_terms).sum()
            else:
                loss_safety = 0.0
            loss_actor = resc * (loss_rew + loss_safety)
            v = functional_call(model.critics, critic, (mb["obs"],))
            loss_vf = ((mb["ret"] - v) ** 2).mean((0, 1)).sum()
            loss = loss_actor + hp["vf_coef"] * loss_vf
            (grad,) = torch.autograd.grad(loss, f)
        aux = dict(loss_actor_rew=loss_rew, loss_actor_total=loss_actor,
                   loss_vf_total=loss_vf,
                   kl=(mb["logp_old"] - log_p).mean(),
                   entropy=dist.entropy().mean())
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, grad

    @torch.no_grad()
    def update(self, state: RecurrentPPOLagState, tr: Transition,
               init_hidden: Tensor, ep_cost_mean: Tensor, n_episodes: Tensor,
               generator: torch.Generator, cost_limit: Tensor | None = None,
               perms: Tensor | None = None, dp=None
               ) -> tuple[RecurrentPPOLagState, dict[str, Tensor]]:
        """One whole-segment update. ``tr`` is time-major (T, N, ...),
        ``init_hidden`` (N, H) the carry at the segment's start. ``perms``
        (repeat, n_minibatches * (N // n_minibatches)) replaces the per-epoch
        env shuffle (the parity tests pass the ones JAX draws). ``dp`` (a
        :class:`fsrl_torch.parallel.mesh.DPGroup`) makes ``tr`` and
        ``init_hidden`` this rank's block of the envs of a data-parallel
        update."""
        hp = self.hp
        dev = self.device
        T, N_local = tr.reward.shape
        N = N_local * (1 if dp is None else dp.size)
        limit = self.cost_limit if cost_limit is None else cost_limit
        lag, cost_in, lam_mult, resc = lagrangian_step(
            hp, state, ep_cost_mean, n_episodes, limit)

        # GAE over the segment, through K1 on the card
        critics = state.params.critics
        values = critics(tr.obs)
        values_next = critics(tr.obs_next) * (~tr.terminated).to(
            values.dtype)[..., None]
        done = (tr.terminated | tr.truncated).contiguous()
        adv, ret = gae_advantages_fused(
            metrics_of(tr).contiguous(), values.contiguous(),
            values_next.contiguous(), done, hp["gamma"], hp["gae_lambda"])

        n_mb, repeat = hp["n_minibatches"], hp["repeat"]
        per_mb = N // n_mb
        if perms is None:
            perms = torch.stack([
                torch.randperm(N, generator=generator, device=dev)
                for _ in range(repeat)])[:, : n_mb * per_mb]
        env_idx = perms.reshape(repeat * n_mb, per_mb)
        if dp is None:
            step_envs = list(env_idx)
        else:
            lo = dp.rank * N_local
            step_envs, counts = owned_rows(env_idx, lo, lo + N_local)
        flat, opt = state.flat, state.opt_state
        stopped = torch.zeros((), dtype=torch.bool, device=dev)
        gsteps = state.gradient_steps
        auxes = []
        kl_acc = torch.zeros((), device=dev)
        for s, idx in enumerate(step_envs):
            mb = dict(obs=tr.obs[:, idx], act=tr.act[:, idx],
                      logp_old=tr.logp[:, idx], adv=adv[:, idx],
                      ret=ret[:, idx], done=done[:, idx],
                      h0=init_hidden[idx])
            adv_mb = mb["adv"].reshape(-1, self.K)
            if hp["norm_adv"]:
                adv_mb = normalize_adv(adv_mb, dp=dp, n_total=T * per_mb)
            if dp is not None and counts[s] == 0:
                # no envs here: this rank adds zeros to the sums
                loss = torch.zeros((), device=dev)
                aux = dict.fromkeys(AUX_NAMES, loss)
                grad = torch.zeros_like(flat)
            else:
                loss, aux, grad = self._loss_grad(state, mb, lam_mult, resc,
                                                  adv_mb)
            if dp is not None:
                (grad,), aux = reduce_step(dp, counts[s] / per_mb, [grad],
                                           dict(aux, _loss=loss))
                loss = aux.pop("_loss")
            updates, new_opt = self.tx.update(grad, opt)
            flat.copy_(torch.where(stopped, flat, flat + updates))
            opt = select_state(stopped, opt, new_opt)
            gsteps = gsteps + (~stopped).to(gsteps.dtype)
            kl_acc = kl_acc + aux["kl"]
            aux["loss_total"] = loss
            auxes.append(aux)
            if is_epoch_end(s, n_mb):
                stopped = stopped | (kl_acc / n_mb > 1.5 * hp["target_kl"])
                kl_acc = torch.zeros_like(kl_acc)

        metrics = ppo_metrics(auxes, resc, lam_mult, stopped)
        new_state = RecurrentPPOLagState(
            params=state.params, flat=flat, opt_state=opt, lag=lag,
            last_ep_cost=cost_in, update_count=state.update_count + 1,
            gradient_steps=gsteps)
        return new_state, metrics
