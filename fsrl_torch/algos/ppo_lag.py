"""PPO-Lagrangian (port of ``fsrl_tpu/algos/ppo_lag.py``).

* clipped (optionally dual-clipped) surrogate on the reward advantage;
* safety loss ``sum_i lambda_i * mean(ratio * advC_i)`` with the
  ``1 / (sum lambda + 1)`` rescale;
* per-minibatch advantage normalization over all channels;
* joint actor + critic Adam on one flat vector, with grad-norm clipping;
* KL early stop at ``1.5 * target_kl`` at each epoch's end, kept on the
  device: after the stop the parameters and the optimizer state (Adam's
  count included) stay frozen, while the remaining grad steps still run and
  still report their metrics, as the JAX scan does;
* PID multiplier update from the collect's mean episodic cost.

Where the config is inside kernel K2's envelope (two hidden layers of any
widths, any observation width and number of actions, up to 5 constraints,
no dual or value clip, advantage normalization on, bounded mean with
``max_action`` 1, f32 or bf16 compute; JAX's ``_pallas_ok`` gate) every
grad step goes through
:func:`fsrl_torch.ops.fused_ppo_grad.ppo_grad_minibatch`: the CUDA kernel on
the card, its plain version on the CPU. Outside it, autograd of the plain
loss, as in JAX. The port has no ``gae_impl`` and no ``use_pallas_grad``
switch, and no 128-row rule: the kernel masks a ragged last chunk.

The parameters live in one flat vector that the module's parameters view;
``update`` writes the new parameters into it in place.

Data parallel (``update(..., dp=)``): each rank holds its block of the envs,
rows ``[r*n, (r+1)*n)`` of the env-major batch, and draws the same tile
permutations. Every grad step takes the global minibatch's rows that the
rank holds (any number, none included), normalizes their advantages by the
whole minibatch's statistics, runs K2 (or autograd) on them, and sums the
flat gradient and the metrics over the ranks, each weighted by the rank's
share of the rows, in one ``all_reduce``; clipping and Adam then run alike
on every rank, and so does the KL early stop. ``dp_blocks`` is JAX's
block-local shuffle: with ``dp_blocks`` = W every minibatch takes the same
number of rows from every rank; with 1 the global shuffle is kept and the
shares are uneven. Unlike JAX, which turns its Pallas kernel off when
``dp_blocks > 1`` (GSPMD cannot partition it), K2 stays on.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch
from torch.func import functional_call

from fsrl_torch.algos.common import (ActorCriticAlgo, AdamState,
                                     OnPolicyBatch, Schedule, lagrangian_step,
                                     make_optimizer, normalize_adv,
                                     ppo_metrics, process_rollout,
                                     reduce_step, select_state)
from fsrl_torch.device import resolve_device
from fsrl_torch.nets.mlp import ActorCritic
from fsrl_torch.ops.fused_ppo_grad import GradLayout, ppo_grad_minibatch
from fsrl_torch.ops.lagrange import PIDLagrangianState
from fsrl_torch.ops.running_stats import RunningMeanStd
from fsrl_torch.types import (TileLayout, Transition, draw_tile_perms,
                              is_epoch_end, minibatch_row_index, owned_rows)
from fsrl_torch.utils.params import unflatten

Tensor = torch.Tensor
# a grad step's metrics besides the loss, in the order the kernel gives them
AUX_NAMES = ("loss_actor_rew", "loss_actor_total", "loss_vf_total", "kl",
             "entropy")


@dataclass
class PPOLagState:
    params: ActorCritic      # its parameters are views of ``flat``
    flat: Tensor             # the flat parameter vector
    opt_state: AdamState
    lag: PIDLagrangianState
    last_ep_cost: Tensor     # (M,)
    ret_rms: RunningMeanStd  # (K,) return statistics (reward normalization)
    update_count: Tensor
    gradient_steps: Tensor


class PPOLag(ActorCriticAlgo):
    """Config plus the init / act / update functions."""

    name = "ppo_lag"

    def __init__(self, obs_dim: int, act_dim: int, *,
                 cost_limit: float | list = 10.0, num_costs: int = 1,
                 hidden_sizes=(128, 128), lr: float | Schedule = 5e-4,
                 target_kl: float = 0.02, vf_coef: float = 0.25,
                 max_grad_norm: float | None = 0.5, gae_lambda: float = 0.95,
                 eps_clip: float = 0.2, dual_clip: float | None = None,
                 value_clip: bool = False,
                 advantage_normalization: bool = True,
                 reward_normalization: bool = False,
                 use_lagrangian: bool = True, pid_filter: bool = True,
                 lagrangian_pid=(0.05, 0.0005, 0.1), rescaling: bool = True,
                 gamma: float = 0.99, unbounded: bool = False,
                 last_layer_scale: bool = True, sigma_init: float = -0.5,
                 max_action: float = 1.0, repeat: int = 4,
                 n_minibatches: int = 4, deterministic_eval: bool = True,
                 compute_dtype: torch.dtype | None = None,
                 episode_len: int | None = None, dp_blocks: int = 1,
                 device=None):
        self.device = resolve_device(device)
        self.obs_dim, self.act_dim = obs_dim, act_dim
        self.num_costs = num_costs
        self.K = 1 + num_costs
        cl = ([cost_limit] * num_costs if isinstance(cost_limit, (int, float))
              else list(cost_limit))
        self.cost_limit = torch.tensor(cl, dtype=torch.float32,
                                       device=self.device)
        self.hp = dict(
            lr=lr, target_kl=target_kl, vf_coef=vf_coef,
            max_grad_norm=max_grad_norm, gae_lambda=gae_lambda,
            eps_clip=eps_clip, dual_clip=dual_clip, value_clip=value_clip,
            norm_adv=advantage_normalization, rew_norm=reward_normalization,
            use_lagrangian=use_lagrangian, pid=tuple(lagrangian_pid),
            pid_filter=pid_filter, rescaling=rescaling, gamma=gamma,
            repeat=repeat, n_minibatches=n_minibatches,
            episode_len=episode_len, dp_blocks=dp_blocks)
        self.hidden_sizes = tuple(hidden_sizes)
        self.deterministic_eval = deterministic_eval
        self.net_kw = dict(max_action=max_action, unbounded=unbounded,
                           last_layer_scale=last_layer_scale,
                           sigma_init=sigma_init)
        self.compute_dtype = compute_dtype
        hs = self.hidden_sizes
        self.grad_layout = GradLayout(D=obs_dim, H=hs[0], A=act_dim, K=self.K,
                                      H2=hs[-1])
        self.use_grad_kernel = (
            len(hs) == 2
            and dual_clip is None and not value_clip
            and advantage_normalization and not unbounded
            and max_action == 1.0
            and compute_dtype in (None, torch.float32, torch.bfloat16)
            and self.grad_layout.kernel_fits())
        self.tx = make_optimizer(lr, max_grad_norm)

    # ---------------- init ----------------
    def init(self, seed: int = 0, state_dict: dict | None = None
             ) -> PPOLagState:
        """Fresh state; ``state_dict`` (e.g. from
        :func:`fsrl_torch.utils.params.from_jax_params`) sets the weights."""
        model, flat = self.init_model(seed, state_dict)
        if self.use_grad_kernel:
            # the kernel reads the flat vector in GradLayout's order
            params = dict(model.named_parameters())
            if [(k, tuple(params[k].shape)) for k in model.flat_names()] != \
                    self.grad_layout.shapes():
                raise ValueError("flat parameter order differs from the "
                                 "fused grad kernel's layout")
        dev = self.device
        return PPOLagState(
            params=model, flat=flat, opt_state=self.tx.init(flat),
            lag=PIDLagrangianState.init(self.num_costs, dev),
            last_ep_cost=torch.zeros(self.num_costs, device=dev),
            ret_rms=RunningMeanStd.init((self.K,), dev), **self._counters())

    # ---------------- loss (autograd path) ----------------
    def _autograd_step(self, state: PPOLagState, mb: OnPolicyBatch,
                       lam_mult: Tensor, resc: Tensor,
                       adv: Tensor | None = None):
        """Loss, metrics and flat gradient by autograd of the plain loss.
        ``adv`` gives the advantages as the loss takes them (already
        normalized); by default they are ``mb.adv``, normalized where the
        config says. The clip is ``minimum(maximum(r, lo), hi)``, whose
        gradient splits ties 0.5/0.5 as JAX's ``clip`` does."""
        hp = self.hp
        model = state.params
        with torch.enable_grad():
            f = state.flat.detach().requires_grad_(True)
            views = unflatten(f, model, model.flat_names())
            dist, values = functional_call(model, views, (mb.obs,))
            log_p = dist.log_prob(mb.act)
            ratio = torch.exp(log_p - mb.logp_old)
            if adv is None:
                adv = normalize_adv(mb.adv) if hp["norm_adv"] else mb.adv
            rew_adv = adv[:, 0]
            eps = hp["eps_clip"]
            surr1 = ratio * rew_adv
            surr2 = torch.minimum(torch.maximum(
                ratio, torch.full_like(ratio, 1 - eps)),
                torch.full_like(ratio, 1 + eps)) * rew_adv
            if hp["dual_clip"] is not None:
                clip1 = torch.minimum(surr1, surr2)
                clip2 = torch.maximum(clip1, hp["dual_clip"] * rew_adv)
                loss_rew = -torch.where(rew_adv < 0, clip2, clip1).mean()
            else:
                loss_rew = -torch.minimum(surr1, surr2).mean()
            if hp["use_lagrangian"]:
                cost_terms = (ratio[:, None] * adv[:, 1:]).mean(0)
                loss_safety = (lam_mult * cost_terms).sum()
            else:
                loss_safety = 0.0
            loss_actor = resc * (loss_rew + loss_safety)
            if hp["value_clip"]:
                v_clip = mb.value_old + torch.clamp(
                    values - mb.value_old, -eps, eps)
                vf = torch.maximum((mb.ret - values) ** 2,
                                   (mb.ret - v_clip) ** 2)
            else:
                vf = (mb.ret - values) ** 2
            loss_vf = vf.mean(0).sum()
            loss = loss_actor + hp["vf_coef"] * loss_vf
            (grad,) = torch.autograd.grad(loss, f)
        aux = dict(loss_actor_rew=loss_rew, loss_actor_total=loss_actor,
                   loss_vf_total=loss_vf,
                   kl=(mb.logp_old - log_p).mean(),
                   entropy=dist.entropy().mean())
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, grad

    # ---------------- update ----------------
    @torch.no_grad()
    def update(self, state: PPOLagState, tr: Transition, ep_cost_mean: Tensor,
               n_episodes: Tensor, generator: torch.Generator,
               cost_limit: Tensor | None = None,
               perms: tuple[Tensor, Tensor] | None = None, dp=None
               ) -> tuple[PPOLagState, dict[str, Tensor]]:
        """One whole-segment update. ``perms`` = ``(tile permutations
        (repeat, usable) or (repeat, dp_blocks, usable), roll offset)``
        replaces the shuffle draw (the parity tests pass the ones JAX
        draws). ``dp`` (a :class:`fsrl_torch.parallel.mesh.DPGroup`) makes
        ``tr`` this rank's block of the envs of a data-parallel update."""
        hp = self.hp
        dev = self.device
        limit = self.cost_limit if cost_limit is None else cost_limit
        lag, cost_in, lam_mult, resc = lagrangian_step(
            hp, state, ep_cost_mean, n_episodes, limit)

        critic = state.params.critics
        if hp["rew_norm"]:
            batch, ret_rms = process_rollout(
                critic, tr, hp["gamma"], hp["gae_lambda"],
                ret_rms=state.ret_rms, episode_len=hp["episode_len"], dp=dp)
        else:
            batch = process_rollout(critic, tr, hp["gamma"],
                                    hp["gae_lambda"],
                                    episode_len=hp["episode_len"], dp=dp)
            ret_rms = state.ret_rms

        n_mb, repeat = hp["n_minibatches"], hp["repeat"]
        n_local = batch.obs.shape[0]
        world = 1 if dp is None else dp.size
        layout = TileLayout.of(n_local * world, n_mb,
                               n_blocks=hp["dp_blocks"])
        if perms is None:
            perms = draw_tile_perms(layout, repeat, generator, dev)
        rows = minibatch_row_index(layout, *perms)     # (repeat*n_mb, rows)
        fields_ = [getattr(batch, f.name) for f in fields(OnPolicyBatch)]
        if dp is None:
            # one gather per field for all grad steps
            mbs = [x[rows] for x in fields_]
            step_rows = [None] * rows.shape[0]
        else:
            lo = dp.rank * n_local
            step_rows, counts = owned_rows(rows, lo, lo + n_local)

        flat, opt = state.flat, state.opt_state
        stopped = torch.zeros((), dtype=torch.bool, device=dev)
        gsteps = state.gradient_steps
        kl_acc = torch.zeros((), device=dev)
        bf16 = self.compute_dtype == torch.bfloat16
        auxes = []
        for s, idx in enumerate(step_rows):
            if dp is None:
                mb = OnPolicyBatch(*(x[s] for x in mbs))
            else:
                mb = OnPolicyBatch(*(x[idx] for x in fields_))
            adv_n = (normalize_adv(mb.adv, dp=dp, n_total=layout.mb_rows)
                     if hp["norm_adv"] else mb.adv)
            if dp is not None and counts[s] == 0:
                # no rows here: this rank adds zeros to the sums
                loss = torch.zeros((), device=dev)
                aux = dict.fromkeys(AUX_NAMES, loss)
                grad = torch.zeros_like(flat)
            elif self.use_grad_kernel:
                loss, aux, grad = ppo_grad_minibatch(
                    flat, self.grad_layout, mb.obs, mb.act, mb.logp_old,
                    adv_n.contiguous(), mb.ret, lam_mult, resc,
                    eps_clip=hp["eps_clip"], vf_coef=hp["vf_coef"],
                    bf16=bf16)
            else:
                loss, aux, grad = self._autograd_step(
                    state, mb, lam_mult, resc, adv_n)
            if dp is not None:
                (grad,), aux = reduce_step(dp, counts[s] / layout.mb_rows,
                                           [grad], dict(aux, _loss=loss))
                loss = aux.pop("_loss")
            updates, new_opt = self.tx.update(grad, opt)
            flat.copy_(torch.where(stopped, flat, flat + updates))
            opt = select_state(stopped, opt, new_opt)
            gsteps = gsteps + (~stopped).to(gsteps.dtype)
            kl_acc = kl_acc + aux["kl"]
            if is_epoch_end(s, n_mb):
                stopped = stopped | (kl_acc / n_mb > 1.5 * hp["target_kl"])
                kl_acc = torch.zeros_like(kl_acc)
            aux["loss_total"] = loss
            auxes.append(aux)

        metrics = ppo_metrics(auxes, resc, lam_mult, stopped)

        new_state = PPOLagState(
            params=state.params, flat=flat, opt_state=opt, lag=lag,
            last_ep_cost=cost_in, ret_rms=ret_rms,
            update_count=state.update_count + 1, gradient_steps=gsteps)
        return new_state, metrics
