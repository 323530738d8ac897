"""Rollout collection on the device (port of ``fsrl_tpu/data/collector.py``).

The JAX collector is one ``lax.scan`` over time; here it is a Python loop
over time whose every step works on the whole batch of envs: policy forward,
physics, auto-reset, cost extraction and episode bookkeeping stay on the
device, and nothing is read back to the host inside the loop.

* Training collection is fixed-length segments (T steps x N envs) with
  auto-reset; episodic statistics come from the completed-episode
  accumulators of :class:`fsrl_torch.types.EpisodeStats`.
* Evaluation (:func:`evaluate`) is episode-exact: one episode per env,
  masked after done.
* Recurrent policies (``init_hidden`` given): the hidden state threads
  through the steps and is reset per env where an episode ended.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

from fsrl_torch.device import resolve_device
from fsrl_torch.envs.base import EnvState, SafeEnv
from fsrl_torch.types import EpisodeStats, Transition

Tensor = torch.Tensor

# act_fn(params, obs, generator) -> (raw_action, logp); a recurrent one is
# act_fn(params, obs, hidden, generator) -> (raw_action, logp, hidden)
ActFn = Callable[..., tuple]


def map_action(act: Tensor, low: float, high: float) -> Tensor:
    """Clip the raw policy output to [-1, 1] and scale it to [low, high]."""
    act = torch.clamp(act, -1.0, 1.0)
    return low + (high - low) * (act + 1.0) / 2.0


def map_action_inverse(act: Tensor, low: float, high: float) -> Tensor:
    """Inverse of :func:`map_action`: env-space action back to [-1, 1]."""
    return torch.clamp(2.0 * (act - low) / (high - low) - 1.0, -1.0, 1.0)


class RolloutResult(NamedTuple):
    env_state: EnvState
    stats: EpisodeStats          # cumulative across the segment
    transitions: Transition      # time-major (T, N, ...)
    hidden: Tensor | None = None        # recurrent carry after the segment
    init_hidden: Tensor | None = None   # and at its start (for BPTT)


def _reset_hidden(hidden: Tensor, fresh: Tensor, done: Tensor) -> Tensor:
    """``fresh`` where the env's episode ended, else ``hidden``."""
    return torch.where(done[:, None], fresh, hidden)


def make_rollout_fn(env: SafeEnv, act_fn: ActFn, num_steps: int,
                    device=None, init_hidden: Callable[[int], Tensor] | None
                    = None):
    """Build ``rollout(params, env_state, stats, generator, reset_states=None,
    hidden=None)`` collecting a ``(num_steps, N)`` segment; N is implied by
    ``env_state``.

    The rollout runs on ``device`` (CUDA unless ``"cpu"`` is given; raises
    without CUDA) and refuses env states elsewhere. ``generator`` draws the
    actions, the steps' draws and the auto-reset states there.
    ``reset_states``, a sequence of ``num_steps`` env states, replaces the
    reset draws (the parity tests pass JAX's).

    Recurrent policies: ``init_hidden(n_envs)`` gives the fresh carry and
    ``act_fn`` takes and returns the hidden state; ``hidden`` is the carry
    to start from (fresh if None), and the result holds the carry at the
    segment's start and end."""
    device = resolve_device(device)
    recurrent = init_hidden is not None

    @torch.no_grad()
    def rollout(params, env_state: EnvState, stats: EpisodeStats,
                generator: torch.Generator,
                reset_states: Sequence[EnvState] | None = None,
                hidden: Tensor | None = None) -> RolloutResult:
        if env_state.obs.device.type != device.type:
            raise ValueError(f"env state on {env_state.obs.device}, rollout "
                             f"built for {device}")
        if recurrent and hidden is None:
            hidden = init_hidden(env_state.obs.shape[0])
        hidden0 = hidden
        steps = []
        for t in range(num_steps):
            obs = env_state.obs
            if recurrent:
                act, logp, hidden = act_fn(params, obs, hidden, generator)
            else:
                act, logp = act_fn(params, obs, generator)
            env_act = map_action(act, env.action_low, env.action_high)
            env_state, ts = env.step_autoreset(
                env_state, env_act, generator,
                fresh=None if reset_states is None else reset_states[t])
            if recurrent:
                hidden = _reset_hidden(hidden, init_hidden(obs.shape[0]),
                                       ts.done)
            stats = stats.update(ts)
            steps.append(Transition(
                obs=obs, act=act, obs_next=ts.obs, reward=ts.reward,
                cost=ts.cost, terminated=ts.terminated,
                truncated=ts.truncated, logp=logp))
        transitions = Transition(**{
            name: torch.stack([getattr(s, name) for s in steps])
            for name in Transition.__dataclass_fields__})
        return RolloutResult(env_state, stats, transitions, hidden, hidden0)

    return rollout


@torch.no_grad()
def evaluate(env: SafeEnv, act_fn: ActFn, params,
             generator: torch.Generator, n_episodes: int,
             init_state: EnvState | None = None,
             init_hidden: Callable[[int], Tensor] | None = None
             ) -> dict[str, Tensor]:
    """Episode-exact evaluation: ``n_episodes`` envs each run exactly one
    episode (latched done mask) for ``max_episode_steps`` steps. Returns
    mean reward, cost (summed over constraints), per-constraint cost,
    length, termination count and reward std, as device tensors.
    ``init_state`` replaces the reset draw (tests). A recurrent policy
    (``init_hidden`` given, 4-argument ``act_fn``) starts each episode from
    the fresh carry."""
    state = (env.reset_vec(n_episodes, generator) if init_state is None
             else init_state)
    hidden = None if init_hidden is None else init_hidden(n_episodes)
    dev = state.obs.device
    N, M = n_episodes, env.num_costs
    alive = torch.ones(N, dtype=torch.bool, device=dev)
    ep_r = torch.zeros(N, device=dev)
    ep_c = torch.zeros(N, M, device=dev)
    ep_len = torch.zeros(N, dtype=torch.int32, device=dev)
    n_term = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(env.max_episode_steps):
        if hidden is None:
            act, _ = act_fn(params, state.obs, generator)
        else:
            act, _, hidden = act_fn(params, state.obs, hidden, generator)
        env_act = map_action(act, env.action_low, env.action_high)
        state, ts = env.step(state, env_act, generator)
        af = alive.to(ep_r.dtype)
        ep_r = ep_r + af * ts.reward
        ep_c = ep_c + af[:, None] * ts.cost
        ep_len = ep_len + alive.to(torch.int32)
        n_term = n_term + (alive & ts.terminated).sum(dtype=torch.int32)
        alive = alive & ~ts.done
    return {
        "reward": ep_r.mean(),
        "cost": ep_c.sum(-1).mean(),
        "cost_per_constraint": ep_c.mean(0),
        "length": ep_len.float().mean(),
        "n_terminated": n_term,
        "reward_std": ep_r.std(unbiased=False),
    }
