"""Core containers and the minibatch shuffle (port of ``fsrl_tpu/types.py``).

Conventions are those of the JAX package:

* rollout data is time-major, leading axes ``(T, N_envs, ...)``;
* ``cost`` is a first-class field of shape ``(..., M)`` for M constraints;
* ``terminated`` (no bootstrap) and ``truncated`` (time limit) stay separate.

JAX's immutable pytrees become plain dataclasses of tensors. Updates return
new objects, like the JAX ``replace`` calls, so a caller can keep the old one.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

Tensor = torch.Tensor


@dataclass
class Timestep:
    """One vectorized environment step's outputs."""

    obs: Tensor          # (N, obs_dim) observation after the step
    reward: Tensor       # (N,)
    cost: Tensor         # (N, M)
    terminated: Tensor   # (N,) bool
    truncated: Tensor    # (N,) bool

    @property
    def done(self) -> Tensor:
        return torch.logical_or(self.terminated, self.truncated)


@dataclass
class Transition:
    """(s, a, r, c, s') transitions, time-major ``(T, N, ...)`` in a rollout."""

    obs: Tensor
    act: Tensor          # raw policy action (before map_action)
    obs_next: Tensor
    reward: Tensor
    cost: Tensor
    terminated: Tensor
    truncated: Tensor
    logp: Tensor         # behaviour log-prob at collection time


@dataclass
class EpisodeStats:
    """Per-env running episode accumulators plus completed-episode aggregates
    (``fsrl_tpu/types.py:63-146``; same update and reset semantics)."""

    ep_reward: Tensor      # (N,)
    ep_cost: Tensor        # (N, M)
    ep_len: Tensor         # (N,) int32
    n_episodes: Tensor     # () int32
    n_steps: Tensor        # () int32
    sum_reward: Tensor     # ()
    sum_cost: Tensor       # (M,)
    sum_len: Tensor        # ()
    n_terminated: Tensor   # () int32
    n_truncated: Tensor    # () int32

    @classmethod
    def init(cls, n_envs: int, n_costs: int = 1,
             device: torch.device | str = "cpu") -> "EpisodeStats":
        f = lambda *s: torch.zeros(s, device=device)
        i = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)
        return cls(ep_reward=f(n_envs), ep_cost=f(n_envs, n_costs),
                   ep_len=i(n_envs), n_episodes=i(), n_steps=i(),
                   sum_reward=f(), sum_cost=f(n_costs), sum_len=f(),
                   n_terminated=i(), n_truncated=i())

    def update(self, ts: Timestep) -> "EpisodeStats":
        """Fold one vectorized env step into the accumulators."""
        ep_reward = self.ep_reward + ts.reward
        ep_cost = self.ep_cost + ts.cost
        ep_len = self.ep_len + 1
        done = ts.done
        donef = done.to(ep_reward.dtype)
        zero = torch.zeros((), dtype=ep_reward.dtype, device=done.device)
        return EpisodeStats(
            ep_reward=torch.where(done, zero, ep_reward),
            ep_cost=torch.where(done[:, None], zero, ep_cost),
            ep_len=torch.where(done, torch.zeros_like(ep_len), ep_len),
            n_episodes=self.n_episodes + done.sum(dtype=torch.int32),
            n_steps=self.n_steps + ep_len.shape[0],
            sum_reward=self.sum_reward + torch.sum(donef * ep_reward),
            sum_cost=self.sum_cost + torch.sum(donef[:, None] * ep_cost, 0),
            sum_len=self.sum_len + torch.sum(donef * ep_len),
            n_terminated=self.n_terminated
            + ts.terminated.sum(dtype=torch.int32),
            n_truncated=self.n_truncated + ts.truncated.sum(dtype=torch.int32),
        )

    def reset_aggregates(self) -> "EpisodeStats":
        """Zero the completed-episode aggregates, keep the per-env running
        accumulators: the start of a new collect window."""
        z = torch.zeros_like
        return dataclasses.replace(
            self, n_episodes=z(self.n_episodes), n_steps=z(self.n_steps),
            sum_reward=z(self.sum_reward), sum_cost=z(self.sum_cost),
            sum_len=z(self.sum_len), n_terminated=z(self.n_terminated),
            n_truncated=z(self.n_truncated))

    @property
    def mean_reward(self) -> Tensor:
        return self.sum_reward / torch.clamp(self.n_episodes, min=1)

    @property
    def mean_cost(self) -> Tensor:
        """Mean episodic cost per constraint, shape (M,)."""
        return self.sum_cost / torch.clamp(self.n_episodes, min=1)

    @property
    def mean_length(self) -> Tensor:
        return self.sum_len / torch.clamp(self.n_episodes, min=1)


# ---------------------------------------------------------------------------
# Minibatch shuffle: ``minibatch_epochs_scan`` (fsrl_tpu/types.py:307-438,
# one roll offset per update) and the per-epoch ``minibatch_scan``
# (fsrl_tpu/types.py:190-304, a fresh key and so a fresh roll offset every
# epoch), one block. With ``tile_size == 1`` the same index arithmetic is
# the exact element shuffle.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TileLayout:
    """The tiling arithmetic of ``minibatch_epochs_scan`` for one block:
    ``tile_size = size // 4096`` (at least 1), ``usable`` whole tiles in a
    multiple of ``n_minibatches``, ``tiles_per_mb`` tiles per minibatch."""

    size: int
    n_minibatches: int
    tile_size: int
    n_tiles: int
    usable: int
    tiles_per_mb: int

    @classmethod
    def of(cls, size: int, n_minibatches: int,
           tile_size: int | None = None) -> "TileLayout":
        ts = max(1, size // 4096) if tile_size is None else tile_size
        n_tiles = size // ts
        usable = (n_tiles // n_minibatches) * n_minibatches
        if usable <= 0:
            raise ValueError(f"{size} rows cannot fill {n_minibatches} "
                             f"minibatches of tile {ts}")
        return cls(size, n_minibatches, ts, n_tiles, usable,
                   usable // n_minibatches)

    @property
    def mb_rows(self) -> int:
        return self.tiles_per_mb * self.tile_size

    @property
    def needs_roll(self) -> bool:
        """Rows past the last whole tile never make it into a tile; the JAX
        code then rotates the batch by a random offset once per update."""
        return self.size % self.tile_size != 0


def draw_tile_perms(layout: TileLayout, n_epochs: int,
                    generator: torch.Generator, device,
                    roll_per_epoch: bool = False) -> tuple[Tensor, Tensor]:
    """Independent tile permutations for every epoch, shape
    ``(n_epochs, usable)``, and the roll offset: a 0-d long tensor, or with
    ``roll_per_epoch`` (the ``minibatch_scan`` schedule) one offset per
    epoch, shape ``(n_epochs,)``; 0 when the tiles cover the batch. Drawn on
    ``device`` with ``generator``."""
    perms = torch.stack([
        torch.randperm(layout.n_tiles, generator=generator,
                       device=device)[: layout.usable]
        for _ in range(n_epochs)])
    shape = (n_epochs,) if roll_per_epoch else ()
    if layout.needs_roll:
        roll = torch.randint(0, layout.size, shape, generator=generator,
                             device=device)
    else:
        roll = torch.zeros(shape, dtype=torch.long, device=device)
    return perms, roll


def minibatch_row_index(layout: TileLayout, perms: Tensor,
                        roll: Tensor | int = 0) -> Tensor:
    """Row indices of every grad step, ``(n_epochs * n_minibatches,
    mb_rows)``: minibatch ``i`` of epoch ``e`` takes tiles
    ``perms[e, i*tpm:(i+1)*tpm]`` in that order, each tile's rows in order.
    ``roll`` reproduces ``jnp.roll(batch, roll, axis=0)`` before tiling:
    one offset for all epochs (0-d) or one per epoch (``(n_epochs,)``).
    Each row appears at most once per epoch."""
    n_epochs = perms.shape[0]
    ts = layout.tile_size
    within = torch.arange(ts, device=perms.device)
    rows = (perms[:, :, None] * ts + within).reshape(
        n_epochs * layout.n_minibatches, layout.mb_rows)
    roll = torch.as_tensor(roll, device=perms.device)
    if roll.dim() == 1:
        roll = roll.repeat_interleave(layout.n_minibatches)[:, None]
    return torch.remainder(rows - roll, layout.size)


def is_epoch_end(step: int, n_minibatches: int) -> bool:
    """True on each epoch's last minibatch (the KL early-stop boundary)."""
    return (step + 1) % n_minibatches == 0
