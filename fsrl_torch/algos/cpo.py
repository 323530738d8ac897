"""Constrained Policy Optimization (port of ``fsrl_tpu/algos/cpo.py``;
Achiam et al. 2017). Single constraint.

Per trust-region step:

* objective ``J = mean(ratio * advR)``; cost surrogate
  ``C = ave_ep_cost + mean(ratio * advC) - mean(advC)``, ``c = C - limit``;
* CG solves ``H^-1 g`` and ``H^-1 b`` (``b = grad(-C)``); scalars
  ``q = g^T H^-1 g``, ``r = g^T H^-1 b``, ``s = b^T H^-1 b``;
* the four optimization cases and the infeasible recovery (case 0) as
  branchless arithmetic, term by term as in the JAX package, with the
  NaN-lambda guard;
* step ``(1 / lambda) (H^-1 g + nu H^-1 b)`` (recovery: ``nu H^-1 b``),
  L2-normalized, then a backtracking line search with the three-part
  acceptance rule (KL <= delta; objective improves if case > 1; cost
  surrogate rises by at most ``max(-c, 0)``); when all ``max_backtracks``
  candidates fail the smallest is applied;
* critics: ``optim_critic_iters`` whole-batch Adam steps on the MSE plus L2
  regularization over every critic parameter.

The line search is an early-exit loop in the JAX package. Here the
candidates are evaluated ``LS_GROUP`` at a time without reading anything
back, and the host asks once per group whether one was accepted: the
accepted index is the same, for one host sync per group. While a CUDA graph
captures the update (:mod:`fsrl_torch.trainer.graphs`) the host cannot ask:
every group is evaluated, and the first accepted candidate is kept on the
device, the same index and step.

Data parallel (``update(..., dp=)``): each rank holds its block of the
batch. The advantages are normalized by the whole batch's statistics; the
gradients ``g`` and ``b`` with the surrogates, every Fisher-vector product,
each line-search group's objectives, cost surrogates and KLs, the final KL
and every critic step are summed over the ranks (weighted by their shares
of the rows) with one ``all_reduce`` each. Every host decision (the
accepted backtrack, ``optim_case``, the NaN guard) is then taken on the
same numbers on every rank.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from fsrl_torch.algos.common import (ActorCriticAlgo, AdamState, Schedule,
                                     apply_flat, critic_steps, global_mean,
                                     make_optimizer, normalize_adv,
                                     process_rollout, split_flat)
from fsrl_torch.device import capturing, resolve_device
from fsrl_torch.nets.mlp import ActorCritic
from fsrl_torch.ops.cg import conjugate_gradient, make_fvp
from fsrl_torch.types import Transition

Tensor = torch.Tensor
EPS = 1e-8
LS_GROUP = 10     # line-search candidates evaluated between two host syncs


@dataclass
class CPOState:
    params: ActorCritic      # its parameters are views of ``flat``
    flat: Tensor             # actor vector, then critic vector
    critic_opt_state: AdamState
    last_ep_cost: Tensor     # (1,)
    update_count: Tensor
    gradient_steps: Tensor


class CPO(ActorCriticAlgo):
    """Config plus the init / act / update functions."""

    name = "cpo"

    def __init__(self, obs_dim: int, act_dim: int, *,
                 cost_limit: float = 10.0, hidden_sizes=(128, 128),
                 lr: float | Schedule = 1e-3, target_kl: float = 0.01,
                 backtrack_coeff: float = 0.8, max_backtracks: int = 100,
                 optim_critic_iters: int = 10, l2_reg: float = 1e-3,
                 gae_lambda: float = 0.95,
                 advantage_normalization: bool = True, gamma: float = 0.99,
                 unbounded: bool = False, last_layer_scale: bool = True,
                 max_action: float = 1.0, cg_iters: int = 10,
                 damping: float = 0.1, deterministic_eval: bool = True,
                 repeat: int = 1, sigma_floor: float | None = None,
                 compute_dtype: torch.dtype | None = None,
                 episode_len: int | None = None, device=None):
        self.device = resolve_device(device)
        self.obs_dim, self.act_dim = obs_dim, act_dim
        self.num_costs = 1
        self.K = 2
        self.cost_limit = float(cost_limit)
        self.hp = dict(
            episode_len=episode_len, target_kl=target_kl,
            backtrack_coeff=backtrack_coeff, max_backtracks=max_backtracks,
            optim_critic_iters=optim_critic_iters, l2_reg=l2_reg,
            gae_lambda=gae_lambda, norm_adv=advantage_normalization,
            gamma=gamma, cg_iters=cg_iters, damping=damping,
            repeat=max(1, int(repeat)))
        self.hidden_sizes = tuple(hidden_sizes)
        self.deterministic_eval = deterministic_eval
        self.net_kw = dict(max_action=max_action, unbounded=unbounded,
                           last_layer_scale=last_layer_scale,
                           sigma_floor=sigma_floor)
        self.compute_dtype = compute_dtype
        self.critic_tx = make_optimizer(lr)

    # ---------------- init ----------------
    def init(self, seed: int = 0, state_dict: dict | None = None) -> CPOState:
        """Fresh state; ``state_dict`` (e.g. from
        :func:`fsrl_torch.utils.params.from_jax_params`) sets the weights."""
        model, flat = self.init_model(seed, state_dict)
        return CPOState(
            params=model, flat=flat,
            critic_opt_state=self.critic_tx.init(split_flat(model, flat)[1]),
            last_ep_cost=torch.zeros(1, device=self.device),
            **self._counters())

    # ---------------- update ----------------
    @torch.no_grad()
    def update(self, state: CPOState, tr: Transition, ep_cost_mean: Tensor,
               n_episodes: Tensor, generator: torch.Generator | None = None,
               cost_limit: Tensor | None = None, dp=None
               ) -> tuple[CPOState, dict[str, Tensor]]:
        """One whole-batch update; draws no random numbers. ``dp`` (a
        :class:`fsrl_torch.parallel.mesh.DPGroup`) makes ``tr`` this rank's
        block of the envs of a data-parallel update."""
        hp = self.hp
        model = state.params
        last_ep_cost = torch.where(n_episodes > 0, ep_cost_mean,
                                   state.last_ep_cost)
        ave_cost = last_ep_cost[0]
        batch = process_rollout(model.critics, tr, hp["gamma"],
                                hp["gae_lambda"],
                                episode_len=hp["episode_len"], dp=dp)
        world = 1 if dp is None else dp.size
        reduce = None if dp is None else global_mean(dp, 1.0 / world)
        adv = (normalize_adv(batch.adv, dp=dp,
                             n_total=batch.adv.shape[0] * world)
               if hp["norm_adv"] else batch.adv)
        limit = self.cost_limit if cost_limit is None \
            else cost_limit.reshape(())

        flat_a, flat_c = split_flat(model, state.flat)
        copt = state.critic_opt_state
        infos = []
        # logp_old and the advantages stay fixed at collect time; each
        # repeat takes its trust region around the current parameters
        for _ in range(hp["repeat"]):
            new_flat, info = self.trust_region_step(
                model, flat_a, batch.obs, batch.act, batch.logp_old,
                adv[:, 0], adv[:, 1], ave_cost, limit, reduce)
            flat_a.copy_(new_flat)
            copt, info["loss/vf_total"] = critic_steps(
                self.critic_tx, model.critics, model.critic_names(), flat_c,
                copt, batch.obs, batch.ret, hp["optim_critic_iters"],
                hp["l2_reg"], reduce)
            infos.append(info)
        metrics = {k: torch.stack([i[k] for i in infos]).mean()
                   for k in infos[0]}

        new_state = CPOState(
            params=model, flat=state.flat, critic_opt_state=copt,
            last_ep_cost=last_ep_cost, update_count=state.update_count + 1,
            gradient_steps=state.gradient_steps
            + hp["repeat"] * hp["optim_critic_iters"])
        return new_state, metrics

    # ---------------- the trust-region step ----------------
    @torch.no_grad()
    def trust_region_step(self, model: ActorCritic, flat_a: Tensor,
                          obs: Tensor, act: Tensor, logp_old: Tensor,
                          advR: Tensor, advC: Tensor, ave_cost: Tensor,
                          limit, reduce=None
                          ) -> tuple[Tensor, dict[str, Tensor]]:
        """One CPO actor step (dual solve and line search) from the actor
        vector ``flat_a``. Returns the new actor vector and the metrics.
        ``reduce`` (data parallel, :func:`global_mean`) makes the rank's
        means over its rows global."""
        hp = self.hp
        glob = reduce or global_mean(None, 1.0)
        delta = hp["target_kl"]
        actor, names = model.actor, model.actor_names()
        old = apply_flat(actor, names, flat_a, obs)
        (mean_advC,) = glob(advC.mean())

        def dist_of(flat):
            return apply_flat(actor, names, flat, obs)

        def surrogates(dist):
            """(objective, cost surrogate) from one actor forward."""
            ratio = torch.exp(dist.log_prob(act) - logp_old)
            return ((ratio * advR).mean(),
                    ave_cost + (ratio * advC).mean() - mean_advC)

        def kl_of(dist):
            return old.kl(dist).mean()       # mean KL(old || new)

        with torch.enable_grad():
            f = flat_a.detach().requires_grad_(True)
            objective0, cost_surr0 = surrogates(dist_of(f))
            (grad_g,) = torch.autograd.grad(objective0, f, retain_graph=True)
            (grad_cost,) = torch.autograd.grad(cost_surr0, f)
        # the surrogates are ave_cost plus means: linear in the ranks' means
        grad_g, grad_cost, objective0, cost_surr0 = glob(
            grad_g, grad_cost, objective0.detach(), cost_surr0.detach())
        grad_b = -grad_cost

        fvp = make_fvp(lambda flat: kl_of(dist_of(flat)), flat_a,
                       hp["damping"], reduce)
        H_inv_g = conjugate_gradient(fvp, grad_g, hp["cg_iters"])
        H_inv_b = conjugate_gradient(fvp, grad_b, hp["cg_iters"])
        Hg = fvp(H_inv_g)
        q = torch.dot(Hg, H_inv_g)
        r = torch.dot(Hg, H_inv_b)
        s = torch.dot(fvp(H_inv_b), H_inv_b)
        c_value = cost_surr0 - limit

        # ---- the four-case dual solve, branchless ----
        zero = torch.zeros_like(q)
        b_negligible = (torch.dot(grad_b, grad_b) <= EPS) & (c_value < 0)
        A = q - r ** 2 / torch.clamp(s, min=EPS)
        B = 2 * delta - c_value ** 2 / torch.clamp(s, min=EPS)
        case = lambda n: torch.full_like(q, n, dtype=torch.int32)
        optim_case = torch.where(
            b_negligible, case(4),
            torch.where((c_value < 0) & (B < 0), case(3),
                        torch.where((c_value < 0) & (B >= 0), case(2),
                                    torch.where(B >= 0, case(1), case(0)))))

        # cases 3 / 4: lam = sqrt(q / 2 delta), nu = 0
        lam_34 = torch.sqrt(torch.clamp(q, min=0.0) / (2 * delta))
        # cases 1 / 2: piecewise projection
        r_over_c = r / torch.where(torch.abs(c_value) < EPS,
                                   torch.sign(c_value) * EPS + EPS, c_value)
        lam_a_raw = torch.sqrt(torch.clamp(A, min=0.0)
                               / torch.clamp(B, min=EPS))
        lam_b_raw = torch.sqrt(torch.clamp(q, min=0.0) / (2 * delta))
        # LA = [0, r/c], LB = [r/c, inf] when c < 0; swapped when c >= 0.
        # clip(x, 0, hi) with hi < 0 gives hi: the upper bound wins
        clip_0_hi = lambda x, hi: torch.minimum(torch.maximum(x, zero), hi)
        neg_c = c_value < 0
        lam_a = torch.where(neg_c, clip_0_hi(lam_a_raw, r_over_c),
                            torch.maximum(lam_a_raw, r_over_c))
        lam_b = torch.where(neg_c, torch.maximum(lam_b_raw, r_over_c),
                            clip_0_hi(lam_b_raw, r_over_c))
        f_a = -0.5 * (A / (lam_a + EPS) + B * lam_a) - r * c_value / (s + EPS)
        f_b = -0.5 * (q / (lam_b + EPS) + 2 * delta * lam_b)
        lam_12 = torch.where(f_a >= f_b, lam_a, lam_b)
        nu_12 = torch.clamp(lam_12 * c_value - r, min=0.0) / (s + EPS)
        # case 0 (recovery): nu = sqrt(2 delta / s), lam = 0
        nu_0 = torch.sqrt(2 * delta / (s + EPS))

        in_34 = optim_case >= 3
        in_12 = (optim_case >= 1) & (optim_case <= 2)
        lam = torch.where(in_34, lam_34, torch.where(in_12, lam_12, zero))
        nu = torch.where(in_34, zero, torch.where(in_12, nu_12, nu_0))

        step_dir = torch.where(
            optim_case > 0,
            (1.0 / (lam + EPS)) * (H_inv_g + nu * H_inv_b), nu * H_inv_b)
        step_dir = step_dir / torch.clamp(torch.linalg.norm(step_dir),
                                          min=EPS)

        # ---- line search: first accepted candidate, LS_GROUP at a time ----
        coeff = torch.full((), hp["backtrack_coeff"], dtype=flat_a.dtype,
                           device=flat_a.device)
        max_bt = hp["max_backtracks"]
        max_rise = torch.clamp(-c_value, min=0.0)

        def cand_values(i: int) -> Tensor:
            """(objective, cost surrogate, KL) of candidate ``i``."""
            dist = dist_of(flat_a + coeff ** float(i) * step_dir)
            return torch.stack([*surrogates(dist), kl_of(dist)])

        def cand_ok(values: Tensor) -> Tensor:
            objective, cost_surr, kl = values
            obj_ok = torch.where(optim_case > 1, objective > objective0,
                                 torch.ones_like(neg_c))
            return ((kl <= delta) & obj_ok
                    & (cost_surr - cost_surr0 <= max_rise))

        # under a CUDA graph's capture the host cannot look: every group
        # is evaluated and the first accepted candidate kept on the device
        sync = not capturing()
        any_ok = torch.zeros_like(neg_c)
        accept_idx = torch.full_like(optim_case, max_bt - 1)
        for start in range(0, max_bt, LS_GROUP):
            idxs = range(start, min(start + LS_GROUP, max_bt))
            (values,) = glob(torch.stack([cand_values(i) for i in idxs]))
            oks = torch.stack([cand_ok(v) for v in values])
            group_ok = oks.any()
            first = start + torch.argmax(oks.to(torch.int32)).to(
                torch.int32)                          # the first maximum
            accept_idx = torch.where(group_ok & ~any_ok, first, accept_idx)
            any_ok = any_ok | group_ok
            if sync and bool(group_ok):               # the host sync
                break
        beta = coeff ** accept_idx.to(flat_a.dtype)
        # NaN guard: skip the update entirely on a NaN lambda
        beta = torch.where(torch.isnan(lam), zero, beta)
        new_flat = flat_a + beta * step_dir

        ok_f = any_ok.float()
        (kl_new,) = glob(kl_of(dist_of(new_flat)))
        metrics = {
            "loss/kl": kl_new,
            "loss/rew_loss": objective0, "loss/cost_loss": cost_surr0,
            "loss/optim_A": A, "loss/optim_B": B, "loss/optim_C": c_value,
            "loss/optim_Q": q, "loss/optim_R": r, "loss/optim_S": s,
            "loss/optim_lam": lam, "loss/optim_nu": nu,
            "loss/optim_case": optim_case.float(),
            "loss/step_size": beta,
            "loss/backtracks": accept_idx.float(),
            "loss/ls_ok": ok_f, "update/line_search_ok": ok_f,
        }
        return new_flat, metrics
