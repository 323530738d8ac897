"""Batched safe-RL environment API (port of ``fsrl_tpu/envs/base.py``).

The JAX envs are written for one instance and ``vmap``-ed; here every hook
works on a batch ``(N, ...)`` directly. The JAX env carries a PRNG key per
instance in its state and splits it in every step; the port draws reset
randomness, and the randomness of a step (a goal resampled on reach), from a
``torch.Generator`` the caller passes, on the generator's device.

Termination follows Gymnasium: ``terminated`` (no bootstrap) vs
``truncated`` (time limit, bootstrap allowed).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from fsrl_torch.types import Timestep

Tensor = torch.Tensor


@dataclass
class EnvState:
    sim: dict          # env-specific physics state: name -> (N, ...) tensor
    obs: Tensor        # (N, obs_dim) current observation
    t: Tensor          # (N,) int32 step-in-episode counter


def _select(mask: Tensor, a: Tensor, b: Tensor) -> Tensor:
    """``where(mask, a, b)`` with ``mask`` (N,) broadcast over trailing axes."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


class SafeEnv:
    """Base class. Subclasses implement ``_init_sim`` (or its two halves,
    ``_reset_draw_shapes`` and ``_init_sim_from``), ``_step_sim``, ``_obs``
    and ``_reward_cost`` on batched sim states."""

    observation_size: int
    action_size: int
    max_episode_steps: int = 500
    num_costs: int = 1
    # policies emit [-1, 1]; the collector rescales to these bounds
    action_low: float = -1.0
    action_high: float = 1.0
    # whether a step draws randomness (_draw_step / _resample)
    draws_in_step: bool = False

    # --- public API ---
    def reset(self, n_envs: int, generator: torch.Generator) -> EnvState:
        sim = self._init_sim(n_envs, generator)
        dev = generator.device
        return EnvState(sim=sim, obs=self._obs(sim),
                        t=torch.zeros(n_envs, dtype=torch.int32, device=dev))

    def step(self, state: EnvState, action: Tensor,
             generator: torch.Generator | None = None,
             draws: dict | None = None) -> tuple[EnvState, Timestep]:
        """One step of every env. An env that draws in a step
        (``draws_in_step``) takes its draws from ``generator``, or from
        ``draws`` where given (the parity tests pass JAX's); the others
        ignore both."""
        action = torch.clamp(action, self.action_low, self.action_high)
        sim = self._step_sim(state.sim, action)
        if self.draws_in_step:
            if draws is None:
                draws = self._draw_step(action.shape[0], generator)
            sim = self._resample(sim, draws)
        obs = self._obs(sim)
        reward, cost = self._reward_cost(state.sim, sim, action)
        t = state.t + 1
        terminated = self._terminated(sim)
        truncated = torch.logical_and(t >= self.max_episode_steps,
                                      torch.logical_not(terminated))
        ts = Timestep(obs=obs, reward=reward, cost=cost[:, : self.num_costs],
                      terminated=terminated, truncated=truncated)
        return EnvState(sim=sim, obs=obs, t=t), ts

    def reset_vec(self, n_envs: int, generator: torch.Generator,
                  stagger: bool = False) -> EnvState:
        """Reset ``n_envs`` instances. ``stagger=True`` spreads the episode
        clocks uniformly over ``[0, max_episode_steps)`` so truncations do
        not arrive in lockstep bursts (training states only, never for
        episode-exact evaluation)."""
        state = self.reset(n_envs, generator)
        if stagger and n_envs > 1:
            offsets = (torch.arange(n_envs, device=state.t.device)
                       * self.max_episode_steps) // n_envs
            state.t = offsets.to(torch.int32)
        return state

    def step_autoreset(self, state: EnvState, action: Tensor,
                       generator: torch.Generator | None = None,
                       fresh: EnvState | None = None,
                       draws: dict | None = None
                       ) -> tuple[EnvState, Timestep]:
        """Step with per-env auto-reset on done. The Timestep holds the true
        final-step signals (``obs`` is the final observation, for
        bootstrapping); the returned state is already reset where done.

        A fresh state is drawn for every env and selected where done, so the
        step has no data-dependent shape and no host sync. ``fresh`` injects
        the reset states and ``draws`` the step's draws (the parity tests
        pass JAX's)."""
        new_state, ts = self.step(state, action, generator, draws)
        if fresh is None:
            fresh = self.reset(action.shape[0], generator)
        done = ts.done
        reset_state = EnvState(
            sim={k: _select(done, fresh.sim[k], v)
                 for k, v in new_state.sim.items()},
            obs=_select(done, fresh.obs, new_state.obs),
            t=torch.where(done, fresh.t, new_state.t))
        return reset_state, ts

    def _constant(self, name: str, values, like: Tensor) -> Tensor:
        """A constant tensor of ``values`` in ``like``'s dtype and device,
        made once for each: a step captured into a CUDA graph cannot copy
        from the host."""
        cache = self.__dict__.setdefault("_constants", {})
        key = (name, like.dtype, like.device)
        if key not in cache:
            cache[key] = torch.tensor(values, dtype=like.dtype,
                                      device=like.device)
        return cache[key]

    # --- subclass hooks ---
    def _init_sim(self, n_envs: int, generator: torch.Generator) -> dict:
        """The reset states: by default ``_init_sim_from`` of the draws of
        ``_reset_draws`` (an env overrides either this or those two)."""
        return self._init_sim_from(self._reset_draws(n_envs, generator))

    def _reset_draws(self, n_envs: int, generator: torch.Generator
                     ) -> list[Tensor]:
        """One ``torch.rand`` of each shape of ``_reset_draw_shapes``, in
        that order."""
        return [torch.rand(s, generator=generator, device=generator.device)
                for s in self._reset_draw_shapes(n_envs)]

    def _reset_draw_shapes(self, n_envs: int) -> list[tuple]:
        raise NotImplementedError

    def _init_sim_from(self, draws: list[Tensor]) -> dict:
        """The reset states from the draws of ``_reset_draws``."""
        raise NotImplementedError

    def _step_sim(self, sim: dict, action: Tensor) -> dict:
        raise NotImplementedError

    def _draw_step(self, n_envs: int, generator: torch.Generator) -> dict:
        """The draws of one step (``draws_in_step`` envs)."""
        raise NotImplementedError

    def _resample(self, sim: dict, draws: dict) -> dict:
        """The stepped sim with the step's draws applied (a goal resampled
        where reached)."""
        raise NotImplementedError

    def _obs(self, sim: dict) -> Tensor:
        raise NotImplementedError

    def _reward_cost(self, sim_prev: dict, sim: dict,
                     action: Tensor) -> tuple[Tensor, Tensor]:
        raise NotImplementedError

    def _terminated(self, sim: dict) -> Tensor:
        n = next(iter(sim.values())).shape[0]
        return torch.zeros(n, dtype=torch.bool,
                           device=next(iter(sim.values())).device)


def uniform(n_shape, low: float, high: float,
            generator: torch.Generator) -> Tensor:
    """``jax.random.uniform(minval=low, maxval=high)`` drawn with a torch
    generator on its own device."""
    u = torch.rand(n_shape, generator=generator, device=generator.device)
    return scale(u, low, high)


def scale(u: Tensor, low: float, high: float) -> Tensor:
    """A draw of ``torch.rand`` moved to ``[low, high)``, as
    :func:`uniform` does."""
    return low + (high - low) * u


_REGISTRY: dict[str, Callable[..., SafeEnv]] = {}


def register(name: str, ctor: Callable[..., SafeEnv]) -> None:
    """Register a task constructor under a gym-style name."""
    _REGISTRY[name] = ctor


def registered_tasks() -> list[str]:
    """The ids of every registered task."""
    import fsrl_torch.envs  # noqa: F401  (registration side effect)
    return sorted(_REGISTRY)


def make(name: str, **kwargs) -> SafeEnv:
    """Create an env by task id, e.g. ``make("SafetyBallRun-v0")``."""
    if name not in _REGISTRY:
        import fsrl_torch.envs  # noqa: F401  (registration side effect)
    if name not in _REGISTRY:
        raise KeyError(f"Unknown task '{name}'. Known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)

