"""Device-resident ring replay buffer with a cost channel (port of
``fsrl_tpu/data/buffer.py``).

One pre-allocated set of ``(C, N_envs, ...)`` tensors on the device, written
a whole rollout segment at a time and sampled by gather. Each env's rows stay
contiguous in its column, so episodes do too.

The write cursor ``pos`` and the fill count ``filled`` are Python ints on the
host: they depend only on how many segments were written, so sampling draws
``torch.randint`` with a host bound and never waits for the device.

n-step linkage follows Tianshou's ``buffer.next``: the successor of a row is
the same env's next row, except at episode ends and at the newest written
row, where it is the row itself (see ``fsrl_torch/ops/nstep.py``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from fsrl_torch.device import resolve_device
from fsrl_torch.types import Transition

Tensor = torch.Tensor


@dataclass
class ReplayBufferState:
    data: Transition     # tensors (C, N, ...)
    pos: int             # next row to write
    filled: int          # number of valid rows (<= C)


class ReplayBuffer:
    """Static configuration; the methods take and return the state. Writes
    go into the state's tensors in place."""

    def __init__(self, capacity_per_env: int, n_envs: int, device=None):
        self.C = int(capacity_per_env)
        self.N = int(n_envs)
        self.device = resolve_device(device)

    def init(self, obs_dim: int, act_dim: int, num_costs: int = 1,
             dtype=torch.float32) -> ReplayBufferState:
        C, N, dev = self.C, self.N, self.device
        z = lambda *s: torch.zeros(s, dtype=dtype, device=dev)
        b = lambda: torch.zeros(C, N, dtype=torch.bool, device=dev)
        data = Transition(obs=z(C, N, obs_dim), act=z(C, N, act_dim),
                          obs_next=z(C, N, obs_dim), reward=z(C, N),
                          cost=z(C, N, num_costs), terminated=b(),
                          truncated=b(), logp=z(C, N))
        return ReplayBufferState(data=data, pos=0, filled=0)

    # ------------------------------------------------------------------
    def add_segment(self, state: ReplayBufferState,
                    tr: Transition) -> ReplayBufferState:
        """Write a ``(T, N, ...)`` segment at the ring cursor (T <= C), as
        at most two slice copies."""
        T, C = tr.reward.shape[0], self.C
        if T > C:
            raise ValueError("segment longer than buffer capacity")
        head = min(T, C - state.pos)
        for f in dataclasses.fields(Transition):
            buf, seg = getattr(state.data, f.name), getattr(tr, f.name)
            buf[state.pos: state.pos + head] = seg[:head]
            if head < T:
                buf[: T - head] = seg[head:]
        return ReplayBufferState(data=state.data, pos=(state.pos + T) % C,
                                 filled=min(state.filled + T, C))

    # ------------------------------------------------------------------
    def sample_indices(self, state: ReplayBufferState, batch_size: int,
                       generator: torch.Generator | None = None,
                       rows: Tensor | None = None,
                       envs: Tensor | None = None) -> Tensor:
        """Uniform flat indices ``row * N + env`` over the valid rows.
        ``rows`` (logical, 0 = oldest) and ``envs`` inject the draws
        (tests); otherwise they come from ``generator``."""
        dev = self.device
        if rows is None:
            rows = torch.randint(0, state.filled, (batch_size,),
                                 generator=generator, device=dev)
        if envs is None:
            envs = torch.randint(0, self.N, (batch_size,),
                                 generator=generator, device=dev)
        # logical row r (0 = oldest) -> physical ring row
        phys = rows if state.filled < self.C else (state.pos + rows) % self.C
        return phys * self.N + envs

    def gather(self, state: ReplayBufferState, flat_idx: Tensor,
               fields: tuple[str, ...] | None = None) -> dict[str, Tensor]:
        """The named fields (all by default) at the flat indices."""
        names = fields or [f.name for f in dataclasses.fields(Transition)]
        out = {}
        for name in names:
            x = getattr(state.data, name)
            out[name] = x.reshape((self.C * self.N,) + x.shape[2:])[flat_idx]
        return out

    # ------------------------------------------------------------------
    def next_flat(self, state: ReplayBufferState) -> Tensor:
        """``(C*N,)`` successor index of each flat slot: the same env's next
        row, stalling at episode ends and at the newest row."""
        C, N, dev = self.C, self.N, self.device
        rows = torch.arange(C, device=dev)[:, None]
        envs = torch.arange(N, device=dev)[None, :]
        here = rows * N + envs
        nxt = ((rows + 1) % C) * N + envs
        newest = (state.pos - 1) % C
        stall = state.data.terminated | state.data.truncated | (rows == newest)
        return torch.where(stall, here, nxt).reshape(-1)

    def end_flag_flat(self, state: ReplayBufferState) -> Tensor:
        """``(C*N,)`` episode-end flags, the whole newest (unfinished) row
        forced to True as the reference does."""
        done = state.data.terminated | state.data.truncated
        done[(state.pos - 1) % self.C] = True
        return done.reshape(-1)

    def metrics_flat(self, state: ReplayBufferState) -> Tensor:
        """``(C*N, K)`` reward and cost channels of the whole buffer."""
        d = state.data
        m = torch.cat([d.reward[..., None], d.cost], -1)
        return m.reshape(-1, m.shape[-1])
