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
* Data parallel: given an :class:`fsrl_torch.parallel.mesh.EnvRows` in the
  place of the generator, a rank steps its block of the envs, runs the
  policy on the global batch (the other ranks' rows zero) and makes every
  draw of a step (the actions' noise, the env's draws, the reset states)
  at the global size, keeping its rows: the segment is the rank's columns
  of the one-process segment.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

from fsrl_torch.device import resolve_device
from fsrl_torch.envs.base import EnvState, SafeEnv
from fsrl_torch.parallel.mesh import EnvRows
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
                    = None, unroll: int = 1):
    """Build ``rollout(params, env_state, stats, generator, reset_states=None,
    hidden=None)`` collecting a ``(num_steps, N)`` segment; N is implied by
    ``env_state``.

    ``unroll`` is the JAX collector's scan unroll. On the card, with
    ``unroll`` u > 1, a plain generator and no injected reset states, the
    steps run as CUDA graphs (:class:`fsrl_torch.trainer.graphs.Dispatch`)
    of u steps, replayed ``num_steps // u`` times, then one of the
    remaining steps, each replay's transitions copied into the segment;
    each graph's first call runs eagerly, as its warm-up. The env state,
    statistics and carry given to such a rollout are donated to the
    graphs, which write into them (the carry at the segment's start comes
    back as a copy). The segment is the eager loop's, bit for bit; on the
    CPU ``unroll`` changes nothing.

    The rollout runs on ``device`` (CUDA unless ``"cpu"`` is given; raises
    without CUDA) and refuses env states elsewhere. ``generator`` draws the
    actions, the steps' draws and the auto-reset states there.
    ``reset_states``, a sequence of ``num_steps`` env states, replaces the
    reset draws (the parity tests pass JAX's). An ``EnvRows`` generator
    (data parallel) draws each step's randomness for every env and keeps
    the rank's rows.

    Recurrent policies: ``init_hidden(n_envs)`` gives the fresh carry and
    ``act_fn`` takes and returns the hidden state; ``hidden`` is the carry
    to start from (fresh if None), and the result holds the carry at the
    segment's start and end."""
    device = resolve_device(device)
    recurrent = init_hidden is not None
    unroll = max(1, min(int(unroll), num_steps))
    graphs = {}      # (steps, generator) -> Dispatch

    def steps(params, env_state, stats, hidden, generator, n,
              reset_states=None):
        """``n`` steps: the new env state, statistics and carry, and the
        list of their transitions."""
        trs = []
        rows = generator if isinstance(generator, EnvRows) else None
        g = generator if rows is None else rows.generator
        for t in range(n):
            obs = env_state.obs
            act_in = (obs, hidden) if recurrent else (obs,)
            if rows is not None:
                act_in = tuple(rows.pad(x) for x in act_in)
            out = act_fn(params, *act_in, g)
            if rows is not None:
                out = rows.cut(out)
            act, logp, *carry = out
            if recurrent:
                hidden = carry[0]
            env_act = map_action(act, env.action_low, env.action_high)
            fresh = None if reset_states is None else reset_states[t]
            draws = None
            if rows is not None:
                # one process's draw order: actions, the step's draws,
                # the reset states
                if env.draws_in_step:
                    draws = rows.cut(env._draw_step(rows.n_total, g))
                if fresh is None:
                    fresh = rows.cut(env.reset(rows.n_total, g))
            env_state, ts = env.step_autoreset(
                env_state, env_act, g, fresh=fresh, draws=draws)
            if recurrent:
                hidden = _reset_hidden(hidden, init_hidden(obs.shape[0]),
                                       ts.done)
            stats = stats.update(ts)
            trs.append(Transition(
                obs=obs, act=act, obs_next=ts.obs, reward=ts.reward,
                cost=ts.cost, terminated=ts.terminated,
                truncated=ts.truncated, logp=logp))
        return env_state, stats, hidden, trs

    def graphed_steps(params, env_state, stats, hidden, generator):
        """The segment from graphs of ``unroll`` steps (see above)."""
        from fsrl_torch.trainer.graphs import Dispatch

        seg, carry, t0 = None, (env_state, stats, hidden), 0
        for n in [unroll] * (num_steps // unroll) + (
                [num_steps % unroll] if num_steps % unroll else []):
            if (n, generator) not in graphs:
                def fn(carry, params, n=n):
                    *carry, trs = steps(params, *carry, generator, n)
                    return tuple(carry), stack(trs)
                graphs[n, generator] = Dispatch(
                    fn, (generator,), name=f"rollout of {n} steps")
            carry, tr = graphs[n, generator](carry, params)
            if seg is None:
                seg = Transition(**{
                    k: x.new_empty((num_steps,) + x.shape[1:])
                    for k, x in vars(tr).items()})
            for k, x in vars(tr).items():
                getattr(seg, k)[t0: t0 + n].copy_(x)
            t0 += n
        return (*carry, seg)

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
        if (unroll > 1 and device.type == "cuda" and reset_states is None
                and isinstance(generator, torch.Generator)):
            if recurrent:
                # the graphs write their new carry into the tensors they
                # are given, this one among them
                hidden0 = hidden.clone()
            env_state, stats, hidden, transitions = graphed_steps(
                params, env_state, stats, hidden, generator)
        else:
            env_state, stats, hidden, trs = steps(
                params, env_state, stats, hidden, generator, num_steps,
                reset_states)
            transitions = stack(trs)
        return RolloutResult(env_state, stats, transitions, hidden, hidden0)

    return rollout


def stack(steps: Sequence[Transition]) -> Transition:
    """Time-major ``(T, N, ...)`` transitions from T steps'."""
    return Transition(**{
        name: torch.stack([getattr(s, name) for s in steps])
        for name in Transition.__dataclass_fields__})


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
