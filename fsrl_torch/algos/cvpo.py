"""CVPO, Constrained Variational Policy Optimization (port of
``fsrl_tpu/algos/cvpo.py``), EM-style constrained RL:

* per-step qc threshold from the episodic limit,
  ``c * (1 - gamma^T) / (1 - gamma) / T``;
* critics: n-step targets from the current actor's action at the terminal
  state through the target critics, min over the heads for the reward and
  mean for the costs, cost targets clamped at 0;
* E-step: ``sample_act_num`` particles per state from the old actor, one
  critic sweep over all ``Kp * B`` pairs, ``estep_iter_num`` Adam steps on
  the logsumexp dual loss over (eta, lambda_i), duals clipped to
  [EPS, ``estep_dual_max``]; lambda is floored by the PID multiplier of the
  realized episodic cost and clipped again; the non-parametric target is
  the softmax over particles of ``(Q0 - sum_i lambda_i Qc_i) / eta``;
* M-step: ``mstep_iter_num`` weighted-MLE steps with the decoupled KL
  penalty; its duals take an Adam step whose *gradient* is
  ``targets - kl`` (fed as is), then are clipped to [0, ``mstep_dual_max``];
* ``pre_update`` resets the M-step duals and their Adam once per collect,
  ``post_update`` copies the actor into the old actor after all updates;
  the target critics take a Polyak step after every grad step.

``update_step`` syncs nothing to the host: its metrics stay tensors.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch
from torch import nn

from fsrl_torch.algos.common import (AdamState, FlatAdam, make_optimizer,
                                     soft_update, split_flat)
from fsrl_torch.algos.offpolicy_base import (OffPolicyAlgo,
                                             clamp_cost_targets, copy_module,
                                             flat_grad, sample_nstep_batch)
from fsrl_torch.data.buffer import ReplayBuffer, ReplayBufferState
from fsrl_torch.nets.distributions import DiagGaussian, gaussian_kl_decoupled
from fsrl_torch.nets.mlp import ActorQCritic, GaussianActor, QCriticEnsemble
from fsrl_torch.ops.lagrange import PIDLagrangianState, filtered_pid_step

Tensor = torch.Tensor
EPS = 1.1920929e-06  # float32 eps * 10, as the reference


@dataclass
class CVPOState:
    params: ActorQCritic          # parameters view ``params.flat``
    actor_old_params: nn.Module   # GaussianActor
    target_critic_params: QCriticEnsemble
    actor_opt_state: AdamState
    critic_opt_state: AdamState
    estep_dual: Tensor            # (1 + M,): eta, lambda_1..M
    estep_opt_state: AdamState
    mstep_dual: Tensor            # (2,): dual_mu, dual_std
    mstep_opt_state: AdamState
    lag: PIDLagrangianState       # the realized-cost backstop
    last_ep_cost: Tensor
    update_count: Tensor
    gradient_steps: Tensor


class CVPO(OffPolicyAlgo):
    """Config plus the init / act / update functions and the per-collect
    hooks."""

    name = "cvpo"

    def __init__(self, obs_dim: int, act_dim: int, *,
                 cost_limit: float | list = 10.0, num_costs: int = 1,
                 max_episode_steps: int = 500, hidden_sizes=(128, 128),
                 actor_lr: float = 5e-4, critic_lr: float = 1e-3,
                 gamma: float = 0.98, n_step: int = 2, tau: float = 0.05,
                 estep_iter_num: int = 1, estep_kl: float = 0.02,
                 estep_dual_max: float = 20.0, estep_dual_lr: float = 0.02,
                 sample_act_num: int = 16, mstep_iter_num: int = 1,
                 mstep_kl_mu: float = 0.005, mstep_kl_std: float = 0.0005,
                 mstep_dual_max: float = 0.5, mstep_dual_lr: float = 0.1,
                 lagrangian_pid=(0.01, 0.0005, 0.0),
                 double_critic: bool = True, max_action: float = 1.0,
                 batch_size: int = 256, deterministic_eval: bool = True,
                 compute_dtype: torch.dtype | None = None, device=None):
        cl = self._setup(obs_dim, act_dim, cost_limit, num_costs,
                         hidden_sizes, max_action, deterministic_eval,
                         compute_dtype, device)
        # per-step qc threshold, computed in double as the reference
        self._qc_coeff = ((1 - gamma ** max_episode_steps) / (1 - gamma)
                          / max_episode_steps)
        self.qc_thres = torch.tensor([c * self._qc_coeff for c in cl],
                                     dtype=torch.float32, device=self.device)
        self.hp = dict(
            gamma=gamma, n_step=n_step, tau=tau,
            estep_iter_num=estep_iter_num, estep_kl=estep_kl,
            estep_dual_max=estep_dual_max, sample_act_num=sample_act_num,
            mstep_iter_num=mstep_iter_num, mstep_kl_mu=mstep_kl_mu,
            mstep_kl_std=mstep_kl_std, mstep_dual_max=mstep_dual_max,
            batch_size=batch_size, pid=tuple(lagrangian_pid))
        self.mstep_targets = torch.tensor([mstep_kl_mu, mstep_kl_std],
                                          device=self.device)
        self.num_q = 2 if double_critic else 1
        self.actor_tx = make_optimizer(actor_lr)
        self.critic_tx = make_optimizer(critic_lr)
        self.estep_tx = FlatAdam(estep_dual_lr)
        self.mstep_tx = FlatAdam(mstep_dual_lr)

    def make_params(self, seed: int = 0) -> ActorQCritic:
        g = torch.Generator().manual_seed(seed)
        actor = GaussianActor(self.obs_dim, self.act_dim, self.hidden_sizes,
                              max_action=self.max_action, unbounded=False,
                              conditioned_sigma=True,
                              compute_dtype=self.compute_dtype, generator=g)
        critics = QCriticEnsemble(self.obs_dim, self.act_dim, self.K,
                                  self.num_q, self.hidden_sizes,
                                  self.compute_dtype, g)
        return ActorQCritic(actor, critics).to(self.device)

    def init(self, seed: int = 0,
             state_dict: dict | None = None) -> CVPOState:
        """Fresh state; ``state_dict`` (e.g. from
        :func:`fsrl_torch.utils.params.from_jax_params`) sets the weights.
        ``estep_dual`` starts at eta = 1, lambda = 0."""
        model = self.init_model(seed, state_dict)
        a, c = split_flat(model, model.flat)
        estep_dual = torch.zeros(self.K, device=self.device)
        estep_dual[0] = 1.0
        mstep_dual = torch.zeros(2, device=self.device)
        return CVPOState(
            params=model, actor_old_params=copy_module(model.actor),
            target_critic_params=copy_module(model.critics),
            actor_opt_state=self.actor_tx.init(a),
            critic_opt_state=self.critic_tx.init(c), estep_dual=estep_dual,
            estep_opt_state=self.estep_tx.init(estep_dual),
            mstep_dual=mstep_dual,
            mstep_opt_state=self.mstep_tx.init(mstep_dual),
            **self._common_state())

    @torch.no_grad()
    def act_fn(self, params: ActorQCritic, obs: Tensor,
               generator: torch.Generator):
        dist = params.actor(obs)
        act = dist.sample(generator)
        return act, dist.log_prob(act)

    @torch.no_grad()
    def act_fn_eval(self, params: ActorQCritic, obs: Tensor,
                    generator: torch.Generator):
        dist = params.actor(obs)
        act = dist.mode() if self.deterministic_eval else dist.sample(
            generator)
        return act, dist.log_prob(act)

    # ------------------------------------------------------------------
    def update_lagrangian(self, state: CVPOState, ep_cost_mean: Tensor,
                          n_episodes: Tensor,
                          cost_limit: Tensor | None = None) -> CVPOState:
        """The backstop dual: the filtered PID on the realized episodic
        cost, a floor for the E-step's lambda that critic lag cannot
        fool."""
        kp, ki, kd = self.hp["pid"]
        limit = self.cost_limit if cost_limit is None else cost_limit
        lag = filtered_pid_step(state.lag, ep_cost_mean, n_episodes, limit,
                                kp, ki, kd)
        return dataclasses.replace(state, lag=lag, last_ep_cost=lag.cost_ema)

    def pre_update(self, state: CVPOState) -> CVPOState:
        """Once per collect: fresh M-step duals and Adam state."""
        mstep_dual = torch.zeros(2, device=self.device)
        return dataclasses.replace(
            state, mstep_dual=mstep_dual,
            mstep_opt_state=self.mstep_tx.init(mstep_dual))

    @torch.no_grad()
    def post_update(self, state: CVPOState) -> CVPOState:
        """Once per collect, after all grad steps: the old actor becomes
        the actor."""
        state.actor_old_params.flat.copy_(
            split_flat(state.params, state.params.flat)[0])
        return state

    # ------------------------------------------------------------------
    def _estep_loss(self, dual: Tensor, q0: Tensor, qc: Tensor,
                    qc_thres: Tensor) -> Tensor:
        hp = self.hp
        eta, lam = dual[0], dual[1:]
        combined = q0 - torch.einsum("m,bkm->bk", lam, qc)
        loss = eta * hp["estep_kl"] + (lam * qc_thres).sum()
        return loss + eta * (torch.logsumexp(combined / eta, 1)
                             - math.log(hp["sample_act_num"])).mean()

    @torch.no_grad()
    def update_step(self, state: CVPOState, buffer: ReplayBuffer,
                    buf_state: ReplayBufferState,
                    generator: torch.Generator | None = None,
                    cost_limit: Tensor | None = None, view=None,
                    draws: dict | None = None, dp=None
                    ) -> tuple[CVPOState, dict[str, Tensor]]:
        """One grad step: critics, E-step, M-step, target critics. A
        ``cost_limit`` given at run time recomputes the qc threshold.
        ``dp`` (data parallel) assembles the sampled batch from the ranks'
        buffers."""
        hp = self.hp
        draws = draws or {}
        model = state.params
        qc_thres = (self.qc_thres if cost_limit is None
                    else cost_limit * self._qc_coeff)

        def target_q_fn(term):
            obs_next = term["obs_next"]
            a = model.actor(obs_next).sample(generator, draws.get("noise_t"))
            q = state.target_critic_params(obs_next, a)
            return torch.cat([q[:, :1].amin(-1), q[:, 1:].mean(-1)], 1)

        batch, rets = sample_nstep_batch(
            buffer, buf_state, generator, hp["batch_size"], hp["n_step"],
            hp["gamma"], target_q_fn, view, draws, dp)
        rets = clamp_cost_targets(rets)
        flat_a, flat_c = split_flat(model, model.flat)
        obs = batch["obs"]

        with torch.enable_grad():
            td = model.critics(obs, batch["act"]) - rets[..., None]
            cl = (td ** 2).mean(0).sum()
            cgrad = flat_grad(cl, model.critics)
        cupd, copt = self.critic_tx.update(cgrad, state.critic_opt_state)
        flat_c.add_(cupd)

        # ---- E-step: particles from the old actor, one critic sweep ----
        Kp, (B, D) = hp["sample_act_num"], obs.shape
        old = state.actor_old_params(obs)
        noise = draws.get("noise_p")
        if noise is None:
            noise = torch.randn((Kp,) + old.mean.shape, generator=generator,
                                device=obs.device)
        sample_act = old.mean + old.std * noise                  # (Kp, B, A)
        q_all = model.critics(obs.expand(Kp, B, D).reshape(Kp * B, D),
                              sample_act.reshape(Kp * B, -1))
        q0 = q_all[:, 0].amin(-1).reshape(Kp, B).T                # (B, Kp)
        qc = q_all[:, 1:].mean(-1).reshape(Kp, B, -1).transpose(0, 1)

        dual, eopt = state.estep_dual, state.estep_opt_state
        elosses = []
        for _ in range(hp["estep_iter_num"]):
            with torch.enable_grad():
                d = dual.detach().requires_grad_(True)
                el = self._estep_loss(d, q0, qc, qc_thres)
                (g,) = torch.autograd.grad(el, d)
            upd, eopt = self.estep_tx.update(g, eopt)
            dual = dual + upd
            elosses.append(el.detach())
        estep_dual = torch.clamp(dual, EPS, hp["estep_dual_max"])
        eta = estep_dual[0]
        # the PID floor of the realized cost, re-capped at the E-step cap
        lam = torch.clamp(torch.maximum(estep_dual[1:], state.lag.multiplier),
                          EPS, hp["estep_dual_max"])
        combined = q0 - torch.einsum("m,bkm->bk", lam, qc)
        optimal_q = torch.softmax(combined / eta, 1)             # (B, Kp)

        # ---- M-step ----
        mu_old, std_old = old.mean[:, None], old.std[:, None]    # (B, 1, A)
        acts = sample_act.transpose(0, 1)                         # (B, Kp, A)
        aopt, mdual, mopt = (state.actor_opt_state, state.mstep_dual,
                             state.mstep_opt_state)
        outs = []
        for _ in range(hp["mstep_iter_num"]):
            with torch.enable_grad():
                dist = model.actor(obs)
                kl_mu, kl_std = gaussian_kl_decoupled(old.mean, old.std,
                                                      dist.mean, dist.std)
                kl_mu, kl_std = kl_mu.mean(), kl_std.mean()
                # dual ascent on (eps - kl) first, as the reference orders
                # it: ``targets - kl`` is the gradient Adam is fed
                dual_grad = self.mstep_targets - torch.stack(
                    [kl_mu, kl_std]).detach()
                mupd, mopt = self.mstep_tx.update(dual_grad, mopt)
                mdual = mdual + mupd
                mdc = torch.clamp(mdual, 0.0, hp["mstep_dual_max"])
                like = (DiagGaussian(dist.mean[:, None], std_old).log_prob(acts)
                        + DiagGaussian(mu_old, dist.std[:, None]).log_prob(
                            acts))
                loss_mle = -(optimal_q * like).mean()
                loss_kl = (mdc[0] * (kl_mu - hp["mstep_kl_mu"])
                           + mdc[1] * (kl_std - hp["mstep_kl_std"]))
                loss = loss_mle + loss_kl
                agrad = flat_grad(loss, model.actor)
            aupd, aopt = self.actor_tx.update(agrad, aopt)
            flat_a.add_(aupd)
            outs.append(torch.stack([loss, loss_mle, kl_mu, kl_std]).detach())
        mloss, mle, kl_mu, kl_std = torch.stack(outs).mean(0)

        soft_update(state.target_critic_params.flat, flat_c, hp["tau"])

        metrics = {
            "loss/q_total": cl.detach(),
            "loss/estep_loss": torch.stack(elosses).mean(),
            "mstep/loss_total": mloss, "mstep/loss_mle": mle,
            "mstep/kl_mu": kl_mu, "mstep/kl_std": kl_std,
            "estep/eta": eta}
        for i in range(self.num_costs):
            metrics[f"estep/lambda{i}"] = lam[i]
            metrics[f"estep/thres_q{i + 1}"] = qc_thres[i]
        return dataclasses.replace(
            state, actor_opt_state=aopt, critic_opt_state=copt,
            estep_dual=estep_dual, estep_opt_state=eopt,
            mstep_dual=mdual, mstep_opt_state=mopt,
            update_count=state.update_count + 1,
            gradient_steps=state.gradient_steps + 1), metrics
