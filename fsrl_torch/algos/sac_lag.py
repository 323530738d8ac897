"""SAC-Lagrangian (port of ``fsrl_tpu/algos/sac_lag.py``).

* tanh-squashed, state-conditioned Gaussian actor; the squashed action is
  what the collector stores and the critics see;
* a double Q critic per metric; only the critics have targets;
* n-step targets from the current actor's action at the terminal state:
  min over the two heads for the reward, max for the costs, the entropy
  bonus ``-alpha * logp`` in the reward channel only, the cost channels'
  targets clamped at 0 (``reference_qc=True``: min-head and entropy in
  every channel, no clamp, as the reference);
* critic loss: both heads against the same target, summed over metrics;
* actor loss ``rescale * (mean(alpha * logp - Q0) + sum_i lambda_i
  mean(pen_i))`` with ``pen_i = relu(max-head Qc_i)``, plus
  ``qc_ucb * |q1 - q2|`` when ``qc_ucb > 0``;
* auto-alpha: Adam on a scalar ``log_alpha`` against target entropy
  ``-act_dim``, then clipped to [-20, 2];
* the PID multiplier steps once per collect (``update_lagrangian``).

``update_step`` syncs nothing to the host: its metrics stay tensors.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from fsrl_torch.algos.common import (AdamState, FlatAdam, make_optimizer,
                                     soft_update, split_flat)
from fsrl_torch.algos.offpolicy_base import (OffPolicyAlgo,
                                             clamp_cost_targets, copy_module,
                                             flat_grad, sample_nstep_batch)
from fsrl_torch.data.buffer import ReplayBuffer, ReplayBufferState
from fsrl_torch.nets.distributions import TanhGaussian
from fsrl_torch.nets.mlp import ActorQCritic, GaussianActor, QCriticEnsemble
from fsrl_torch.ops.lagrange import PIDLagrangianState, rescaling_factor

Tensor = torch.Tensor


@dataclass
class SACLagState:
    params: ActorQCritic         # parameters view ``params.flat``
    target_critic_params: QCriticEnsemble
    actor_opt_state: AdamState
    critic_opt_state: AdamState
    log_alpha: Tensor            # ()
    alpha_opt_state: AdamState
    lag: PIDLagrangianState
    last_ep_cost: Tensor         # (M,)
    update_count: Tensor
    gradient_steps: Tensor


def _heads(q: Tensor, reference_qc: bool) -> Tensor:
    """``(B, K, 2)`` -> ``(B, K)``: min over the heads for the reward
    channel, max for the costs (min everywhere with ``reference_qc``).
    ``amin`` / ``amax`` split the gradient evenly at a tie, as JAX's
    reductions do."""
    if reference_qc:
        return q.amin(-1)
    return torch.cat([q[:, :1].amin(-1), q[:, 1:].amax(-1)], 1)


class SACLag(OffPolicyAlgo):
    """Config plus the init / act / update functions."""

    name = "sac_lag"

    def __init__(self, obs_dim: int, act_dim: int, *,
                 cost_limit: float | list = 10.0, num_costs: int = 1,
                 hidden_sizes=(128, 128), actor_lr: float = 5e-4,
                 critic_lr: float = 1e-3, alpha: float = 0.005,
                 auto_alpha: bool = True, alpha_lr: float = 3e-4,
                 tau: float = 0.05, n_step: int = 2,
                 use_lagrangian: bool = True, pid_filter: bool = True,
                 reference_qc: bool = False, qc_ucb: float = 0.0,
                 lagrangian_pid=(0.05, 0.0005, 0.1), rescaling: bool = True,
                 gamma: float = 0.99, max_action: float = 1.0,
                 batch_size: int = 256, deterministic_eval: bool = False,
                 compute_dtype: torch.dtype | None = None, device=None):
        self._setup(obs_dim, act_dim, cost_limit, num_costs, hidden_sizes,
                    max_action, deterministic_eval, compute_dtype, device)
        self.hp = dict(
            tau=tau, n_step=n_step, use_lagrangian=use_lagrangian,
            pid=tuple(lagrangian_pid), pid_filter=pid_filter,
            reference_qc=reference_qc, qc_ucb=qc_ucb, rescaling=rescaling,
            gamma=gamma, batch_size=batch_size, auto_alpha=auto_alpha,
            target_entropy=-float(act_dim))
        self.fixed_alpha = float(alpha)
        self.actor_tx = make_optimizer(actor_lr)
        self.critic_tx = make_optimizer(critic_lr)
        self.alpha_tx = FlatAdam(alpha_lr)

    def make_params(self, seed: int = 0) -> ActorQCritic:
        g = torch.Generator().manual_seed(seed)
        actor = GaussianActor(self.obs_dim, self.act_dim, self.hidden_sizes,
                              max_action=self.max_action, unbounded=True,
                              conditioned_sigma=True,
                              compute_dtype=self.compute_dtype, generator=g)
        critics = QCriticEnsemble(self.obs_dim, self.act_dim, self.K, 2,
                                  self.hidden_sizes, self.compute_dtype, g)
        return ActorQCritic(actor, critics).to(self.device)

    def init(self, seed: int = 0,
             state_dict: dict | None = None) -> SACLagState:
        """Fresh state; ``state_dict`` (e.g. from
        :func:`fsrl_torch.utils.params.from_jax_params`) sets the weights.
        ``log_alpha`` starts at 0 with auto-alpha, else at log(alpha)."""
        model = self.init_model(seed, state_dict)
        a, c = split_flat(model, model.flat)
        dev = self.device
        log_alpha = (torch.zeros((), device=dev) if self.hp["auto_alpha"]
                     else torch.log(torch.tensor(self.fixed_alpha,
                                                 device=dev)))
        return SACLagState(
            params=model, target_critic_params=copy_module(model.critics),
            actor_opt_state=self.actor_tx.init(a),
            critic_opt_state=self.critic_tx.init(c), log_alpha=log_alpha,
            alpha_opt_state=self.alpha_tx.init(log_alpha),
            **self._common_state())

    def _dist(self, actor: GaussianActor, obs: Tensor) -> TanhGaussian:
        d = actor(obs)
        return TanhGaussian(mean=d.mean, std=d.std)

    @torch.no_grad()
    def act_fn(self, params: ActorQCritic, obs: Tensor,
               generator: torch.Generator):
        return self._dist(params.actor, obs).sample_and_log_prob(generator)

    @torch.no_grad()
    def act_fn_eval(self, params: ActorQCritic, obs: Tensor,
                    generator: torch.Generator):
        dist = self._dist(params.actor, obs)
        if self.deterministic_eval:
            return dist.mode(), obs.new_zeros(obs.shape[:-1])
        return dist.sample_and_log_prob(generator)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def update_step(self, state: SACLagState, buffer: ReplayBuffer,
                    buf_state: ReplayBufferState,
                    generator: torch.Generator | None = None, view=None,
                    draws: dict | None = None
                    ) -> tuple[SACLagState, dict[str, Tensor]]:
        """One grad step: critics, actor against the updated critics,
        alpha, then the target critics."""
        hp = self.hp
        draws = draws or {}
        model = state.params
        ref = hp["reference_qc"]
        alpha = torch.exp(state.log_alpha)

        def target_q_fn(term):
            obs_next = term["obs_next"]
            a, logp = self._dist(model.actor, obs_next).sample_and_log_prob(
                generator, draws.get("noise_t"))
            minq = _heads(state.target_critic_params(obs_next, a), ref)
            if ref:
                return minq - alpha * logp[:, None]
            # the entropy bonus in the reward channel only: cost critics
            # estimate pure cost-to-go
            return torch.cat([minq[:, :1] - alpha * logp[:, None],
                              minq[:, 1:]], 1)

        batch, rets = sample_nstep_batch(
            buffer, buf_state, generator, hp["batch_size"], hp["n_step"],
            hp["gamma"], target_q_fn, view, draws)
        if not ref:
            rets = clamp_cost_targets(rets)
        flat_a, flat_c = split_flat(model, model.flat)
        obs = batch["obs"]

        # ---- critics: both heads against the same target ----
        with torch.enable_grad():
            td = model.critics(obs, batch["act"]) - rets[..., None]
            cl = (td ** 2).mean(0).sum()
            cgrad = flat_grad(cl, model.critics)
        cupd, copt = self.critic_tx.update(cgrad, state.critic_opt_state)
        flat_c.add_(cupd)

        # ---- actor, against the updated critics ----
        lam = state.lag.multiplier
        resc = (rescaling_factor(lam, hp["rescaling"])
                if hp["use_lagrangian"] else torch.ones((), device=lam.device))
        with torch.enable_grad():
            a, logp = self._dist(model.actor, obs).sample_and_log_prob(
                generator, draws.get("noise_a"))
            q_all = model.critics(obs, a)                       # (B, K, 2)
            q = _heads(q_all, ref)
            if ref:
                qc_pen = q[:, 1:]
            else:
                # a negative cost-Q is an estimation artifact: no pull
                qc_pen = torch.relu(q[:, 1:])
                if hp["qc_ucb"] > 0:
                    spread = (q_all[:, 1:, 0] - q_all[:, 1:, 1]).abs()
                    qc_pen = qc_pen + hp["qc_ucb"] * spread
            loss_rew = (alpha * logp - q[:, 0]).mean()
            loss_safety = ((lam * qc_pen.mean(0)).sum()
                           if hp["use_lagrangian"] else 0.0)
            al = resc * (loss_rew + loss_safety)
            agrad = flat_grad(al, model.actor)
        aupd, aopt = self.actor_tx.update(agrad, state.actor_opt_state)
        flat_a.add_(aupd)

        # ---- auto alpha ----
        log_alpha, alpha_opt = state.log_alpha, state.alpha_opt_state
        alpha_loss = torch.zeros((), device=lam.device)
        if hp["auto_alpha"]:
            logp_d = logp.detach() + hp["target_entropy"]
            with torch.enable_grad():
                la = log_alpha.detach().requires_grad_(True)
                alpha_loss = -(la * logp_d).mean()
                (g,) = torch.autograd.grad(alpha_loss, la)
            upd, alpha_opt = self.alpha_tx.update(g, alpha_opt)
            # bounded alpha: the ascent runs away when a large multiplier
            # holds the policy at low entropy
            log_alpha = torch.clamp(log_alpha + upd, -20.0, 2.0)
            alpha_loss = alpha_loss.detach()

        soft_update(state.target_critic_params.flat, flat_c, hp["tau"])

        metrics = self._lag_metrics(lam, {
            "loss/q_total": cl.detach(), "loss/actor_total": al.detach(),
            "loss/actor_rew": loss_rew.detach(),
            "loss/alpha_value": torch.exp(log_alpha),
            "loss/alpha_loss": alpha_loss, "loss/rescaling": resc})
        return dataclasses.replace(
            state, actor_opt_state=aopt, critic_opt_state=copt,
            log_alpha=log_alpha, alpha_opt_state=alpha_opt,
            update_count=state.update_count + 1,
            gradient_steps=state.gradient_steps + 1), metrics
