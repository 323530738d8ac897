"""DDPG-Lagrangian (port of ``fsrl_tpu/algos/ddpg_lag.py``).

* deterministic actor; exploration adds Gaussian noise (0.1 by default),
  and the collector stores the noised action before its clip;
* one Q critic per metric, with target networks for actor and critics and
  a Polyak ``tau`` update after every grad step;
* n-step targets through the target actor and critics, the cost channels'
  targets clamped at 0;
* actor loss ``rescale * (-mean Q0 + sum_i lambda_i mean relu(Qc_i))``;
* the PID multiplier steps once per collect (``update_lagrangian``), on the
  collect's mean episodic cost.

``update_step`` syncs nothing to the host: its metrics stay tensors.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from fsrl_torch.algos.common import (AdamState, make_optimizer, soft_update,
                                     split_flat)
from fsrl_torch.algos.offpolicy_base import (OffPolicyAlgo,
                                             clamp_cost_targets, copy_module,
                                             flat_grad, sample_nstep_batch)
from fsrl_torch.data.buffer import ReplayBuffer, ReplayBufferState
from fsrl_torch.nets.mlp import (ActorQCritic, DeterministicActor,
                                 QCriticEnsemble)
from fsrl_torch.ops.lagrange import PIDLagrangianState, rescaling_factor

Tensor = torch.Tensor


@dataclass
class DDPGLagState:
    params: ActorQCritic         # parameters view ``params.flat``
    target_params: ActorQCritic
    actor_opt_state: AdamState
    critic_opt_state: AdamState
    lag: PIDLagrangianState
    last_ep_cost: Tensor         # (M,)
    update_count: Tensor
    gradient_steps: Tensor


class DDPGLag(OffPolicyAlgo):
    """Config plus the init / act / update functions."""

    name = "ddpg_lag"

    def __init__(self, obs_dim: int, act_dim: int, *,
                 cost_limit: float | list = 10.0, num_costs: int = 1,
                 hidden_sizes=(128, 128), actor_lr: float = 1e-4,
                 critic_lr: float = 1e-3, tau: float = 0.005,
                 exploration_noise: float = 0.1, n_step: int = 3,
                 use_lagrangian: bool = True, pid_filter: bool = True,
                 lagrangian_pid=(0.5, 0.001, 0.1), rescaling: bool = True,
                 gamma: float = 0.99, max_action: float = 1.0,
                 batch_size: int = 256, deterministic_eval: bool = True,
                 compute_dtype: torch.dtype | None = None, device=None):
        self._setup(obs_dim, act_dim, cost_limit, num_costs, hidden_sizes,
                    max_action, deterministic_eval, compute_dtype, device)
        self.hp = dict(
            tau=tau, noise=exploration_noise, n_step=n_step,
            use_lagrangian=use_lagrangian, pid=tuple(lagrangian_pid),
            pid_filter=pid_filter, rescaling=rescaling, gamma=gamma,
            batch_size=batch_size)
        self.actor_tx = make_optimizer(actor_lr)
        self.critic_tx = make_optimizer(critic_lr)

    def make_params(self, seed: int = 0) -> ActorQCritic:
        g = torch.Generator().manual_seed(seed)
        actor = DeterministicActor(self.obs_dim, self.act_dim,
                                   self.hidden_sizes, self.max_action,
                                   self.compute_dtype, g)
        critics = QCriticEnsemble(self.obs_dim, self.act_dim, self.K, 1,
                                  self.hidden_sizes, self.compute_dtype, g)
        return ActorQCritic(actor, critics).to(self.device)

    def init(self, seed: int = 0,
             state_dict: dict | None = None) -> DDPGLagState:
        """Fresh state; ``state_dict`` (e.g. from
        :func:`fsrl_torch.utils.params.from_jax_params`) sets the weights."""
        model = self.init_model(seed, state_dict)
        a, c = split_flat(model, model.flat)
        return DDPGLagState(
            params=model, target_params=copy_module(model),
            actor_opt_state=self.actor_tx.init(a),
            critic_opt_state=self.critic_tx.init(c), **self._common_state())

    # exploration: actor output plus Gaussian noise, stored before the clip
    @torch.no_grad()
    def act_fn(self, params: ActorQCritic, obs: Tensor,
               generator: torch.Generator):
        act = params.actor(obs)
        act = act + self.hp["noise"] * torch.randn(
            act.shape, generator=generator, device=act.device)
        return act, act.new_zeros(act.shape[:-1])

    @torch.no_grad()
    def act_fn_eval(self, params: ActorQCritic, obs: Tensor,
                    generator: torch.Generator):
        act = params.actor(obs)
        return act, act.new_zeros(act.shape[:-1])

    # ------------------------------------------------------------------
    @torch.no_grad()
    def update_step(self, state: DDPGLagState, buffer: ReplayBuffer,
                    buf_state: ReplayBufferState,
                    generator: torch.Generator | None = None, view=None,
                    draws: dict | None = None
                    ) -> tuple[DDPGLagState, dict[str, Tensor]]:
        """One grad step on a sampled batch: critics, then the actor
        against the updated critics, then both targets."""
        hp = self.hp
        model, target = state.params, state.target_params

        def target_q_fn(term):
            obs_next = term["obs_next"]
            return target.critics(obs_next, target.actor(obs_next))[..., 0]

        batch, rets = sample_nstep_batch(
            buffer, buf_state, generator, hp["batch_size"], hp["n_step"],
            hp["gamma"], target_q_fn, view, draws)
        rets = clamp_cost_targets(rets)
        flat_a, flat_c = split_flat(model, model.flat)

        # ---- critics ----
        with torch.enable_grad():
            q = model.critics(batch["obs"], batch["act"])[..., 0]   # (B, K)
            cl = ((q - rets) ** 2).mean(0).sum()
            cgrad = flat_grad(cl, model.critics)
        cupd, copt = self.critic_tx.update(cgrad, state.critic_opt_state)
        flat_c.add_(cupd)

        # ---- actor, against the updated critics ----
        lam = state.lag.multiplier
        resc = (rescaling_factor(lam, hp["rescaling"])
                if hp["use_lagrangian"] else torch.ones((), device=lam.device))
        with torch.enable_grad():
            q = model.critics(batch["obs"], model.actor(batch["obs"]))[..., 0]
            loss_rew = -q[:, 0].mean()
            loss_safety = ((lam * torch.relu(q[:, 1:]).mean(0)).sum()
                           if hp["use_lagrangian"] else 0.0)
            al = resc * (loss_rew + loss_safety)
            agrad = flat_grad(al, model.actor)
        aupd, aopt = self.actor_tx.update(agrad, state.actor_opt_state)
        flat_a.add_(aupd)
        soft_update(target.flat, model.flat, hp["tau"])

        metrics = self._lag_metrics(lam, {
            "loss/q_total": cl.detach(), "loss/actor_total": al.detach(),
            "loss/actor_rew": loss_rew.detach(), "loss/rescaling": resc})
        return dataclasses.replace(
            state, actor_opt_state=aopt, critic_opt_state=copt,
            update_count=state.update_count + 1,
            gradient_steps=state.gradient_steps + 1), metrics
