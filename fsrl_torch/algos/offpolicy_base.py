"""Shared off-policy machinery (port of ``fsrl_tpu/algos/offpolicy_base.py``):
n-step targets sampled from the ring replay buffer through target networks,
and what DDPG-Lag, SAC-Lag and CVPO share.

Each network's parameters are views of one flat vector, kept on the module
as ``module.flat``; the optimizers and the Polyak updates work on those
vectors in place. Random draws come from a ``torch.Generator``, or from a
``draws`` dict that injects them (the parity tests pass JAX's):

* ``rows``, ``envs``: the sampled logical rows and envs, ``(B,)`` each;
* ``noise_t``: the normal draw of the action at the n-step terminal,
  ``(B, A)`` (SAC-Lag, CVPO);
* ``noise_a``: the actor loss's action draw, ``(B, A)`` (SAC-Lag);
* ``noise_p``: the E-step particles' draw, ``(Kp, B, A)`` (CVPO).
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch import nn

from fsrl_torch.data.buffer import ReplayBuffer, ReplayBufferState
from fsrl_torch.device import resolve_device
from fsrl_torch.ops.lagrange import PIDLagrangianState, pid_controller_step
from fsrl_torch.ops.nstep import nstep_forward_indices, nstep_targets
from fsrl_torch.utils.params import flatten_parameters_

Tensor = torch.Tensor


@dataclass
class NStepView:
    """Buffer-wide arrays the n-step sampler needs, built once per collect:
    the buffer does not change while the grad steps run, and building them
    in every step would touch all ``C*N`` rows each time."""

    next_flat: Tensor   # (C*N,)
    end_flag: Tensor    # (C*N,)
    metrics: Tensor     # (C*N, K)


def make_nstep_view(buffer: ReplayBuffer,
                    buf_state: ReplayBufferState) -> NStepView:
    return NStepView(next_flat=buffer.next_flat(buf_state),
                     end_flag=buffer.end_flag_flat(buf_state),
                     metrics=buffer.metrics_flat(buf_state))


def sample_nstep_batch(
    buffer: ReplayBuffer, buf_state: ReplayBufferState,
    generator: Optional[torch.Generator], batch_size: int, n_step: int,
    gamma: float, target_q_fn: Callable[[dict], Tensor],
    view: Optional[NStepView] = None, draws: Optional[dict] = None,
) -> tuple[dict[str, Tensor], Tensor]:
    """Sample a batch and its per-channel n-step targets.

    Returns ``(batch, rets (B, K))``: ``batch`` holds ``obs`` and ``act`` at
    the sampled indices. ``target_q_fn`` gets ``obs_next`` and
    ``terminated`` at the chain's terminal indices and returns the ``(B, K)``
    target value of ``obs_next`` there; it is zeroed where terminated
    (the reference's value mask)."""
    if view is None:
        view = make_nstep_view(buffer, buf_state)
    draws = draws or {}
    idx = buffer.sample_indices(buf_state, batch_size, generator,
                                draws.get("rows"), draws.get("envs"))
    chain = nstep_forward_indices(idx, view.next_flat, n_step)
    term = buffer.gather(buf_state, chain[-1], ("obs_next", "terminated"))
    with torch.no_grad():
        target_q = target_q_fn(term)
    target_q = target_q * (~term["terminated"]).to(target_q.dtype)[:, None]
    rets = nstep_targets(view.metrics, view.end_flag, target_q, chain, gamma)
    return buffer.gather(buf_state, idx, ("obs", "act")), rets


def clamp_cost_targets(rets: Tensor) -> Tensor:
    """Cost-to-go is nonnegative: the cost channels' targets are clamped
    at 0, the reward channel's kept."""
    return torch.cat([rets[:, :1], torch.clamp(rets[:, 1:], min=0.0)], 1)


def flat_module(module: nn.Module) -> nn.Module:
    """Make ``module``'s parameters views of one flat vector, in
    ``module.flat_names()`` order where it has one (else parameter order),
    and keep the vector as ``module.flat``."""
    names = (module.flat_names() if hasattr(module, "flat_names")
             else [k for k, _ in module.named_parameters()])
    module.flat = flatten_parameters_(module, names)
    return module


def copy_module(module: nn.Module) -> nn.Module:
    """An independent copy with its own flat vector (target networks)."""
    return flat_module(copy.deepcopy(module))


def flat_grad(loss: Tensor, module: nn.Module) -> Tensor:
    """Gradient of ``loss`` with respect to ``module``'s parameters, as one
    vector in parameter order."""
    grads = torch.autograd.grad(loss, list(module.parameters()))
    return torch.cat([g.reshape(-1) for g in grads])


class OffPolicyAlgo:
    """Configuration the three algorithms share: device, sizes, nets'
    keywords, the cost limits, and the PID multiplier step of DDPG-Lag and
    SAC-Lag. A subclass sets ``hp`` (with ``use_lagrangian``, ``pid`` and
    ``pid_filter`` where it uses ``update_lagrangian``) and
    ``make_params``."""

    def _setup(self, obs_dim: int, act_dim: int, cost_limit, num_costs: int,
               hidden_sizes, max_action: float, deterministic_eval: bool,
               compute_dtype, device) -> list[float]:
        self.device = resolve_device(device)
        self.obs_dim, self.act_dim = obs_dim, act_dim
        self.num_costs = num_costs
        self.K = 1 + num_costs
        self.hidden_sizes = tuple(hidden_sizes)
        self.max_action = max_action
        self.deterministic_eval = deterministic_eval
        self.compute_dtype = compute_dtype
        cl = ([cost_limit] * num_costs if isinstance(cost_limit, (int, float))
              else list(cost_limit))
        self.cost_limit = torch.tensor(cl, dtype=torch.float32,
                                       device=self.device)
        return cl

    def init_model(self, seed: int = 0,
                   state_dict: dict | None = None) -> nn.Module:
        """``make_params(seed)`` (orthogonal init from a seeded CPU
        generator, on the algorithm's device), its weights set from
        ``state_dict`` (e.g. from
        :func:`fsrl_torch.utils.params.from_jax_params`) if given, behind
        one flat vector."""
        model = self.make_params(seed)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        return flat_module(model)

    def _common_state(self) -> dict:
        z = lambda: torch.zeros((), dtype=torch.int32, device=self.device)
        return dict(lag=PIDLagrangianState.init(self.num_costs, self.device),
                    last_ep_cost=torch.zeros(self.num_costs,
                                             device=self.device),
                    update_count=z(), gradient_steps=z())

    def _lag_metrics(self, lam: Tensor, metrics: dict) -> dict:
        for i in range(self.num_costs):
            metrics[f"loss/lagrangian{'' if i == 0 else '_' + str(i)}"] = \
                lam[i]
        return metrics

    def update_lagrangian(self, state, ep_cost_mean: Tensor,
                          n_episodes: Tensor,
                          cost_limit: Tensor | None = None):
        """Once per collect: the PID step on the collect's mean episodic
        cost (filtered by default), held when no episode finished."""
        if not self.hp["use_lagrangian"]:
            return state
        kp, ki, kd = self.hp["pid"]
        limit = self.cost_limit if cost_limit is None else cost_limit
        lag = pid_controller_step(state.lag, ep_cost_mean, n_episodes, limit,
                                  kp, ki, kd, filtered=self.hp["pid_filter"])
        return dataclasses.replace(state, lag=lag, last_ep_cost=lag.cost_ema)
