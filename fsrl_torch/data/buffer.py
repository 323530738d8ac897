"""Device-resident ring replay buffer with a cost channel (port of
``fsrl_tpu/data/buffer.py``).

One pre-allocated set of ``(C, N_envs, ...)`` tensors on the device, written
a whole rollout segment at a time and sampled by gather. Each env's rows stay
contiguous in its column, so episodes do too.

The fill count ``filled`` is a Python int on the host: it depends only on
how many segments were written, so sampling draws ``torch.randint`` with a
host bound and never waits for the device. The write cursor ``pos`` is a
0-d device tensor, and the segment is written at device indices: a CUDA
graph that writes or samples the buffer (:mod:`fsrl_torch.trainer.graphs`)
then reads the cursor at replay, not at capture.

n-step linkage follows Tianshou's ``buffer.next``: the successor of a row is
the same env's next row, except at episode ends and at the newest written
row, where it is the row itself (see ``fsrl_torch/ops/nstep.py``).

Data parallel: a rank's buffer holds the columns of its block of envs,
``[env_offset, env_offset + n_envs)`` of ``n_envs_total``; it draws the
global ``(rows, envs)`` and says which of them it holds
(:meth:`ReplayBuffer.sample_indices`).
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
    pos: Tensor          # () long: the next row to write
    filled: int          # number of valid rows (<= C)


class ReplayBuffer:
    """Static configuration; the methods take and return the state. Writes
    go into the state's tensors in place."""

    def __init__(self, capacity_per_env: int, n_envs: int, device=None,
                 n_envs_total: int | None = None, env_offset: int = 0):
        self.C = int(capacity_per_env)
        self.N = int(n_envs)
        self.device = resolve_device(device)
        self.n_envs_total = self.N if n_envs_total is None else int(
            n_envs_total)
        self.env_offset = int(env_offset)

    def init(self, obs_dim: int, act_dim: int, num_costs: int = 1,
             dtype=torch.float32) -> ReplayBufferState:
        C, N, dev = self.C, self.N, self.device
        z = lambda *s: torch.zeros(s, dtype=dtype, device=dev)
        b = lambda: torch.zeros(C, N, dtype=torch.bool, device=dev)
        data = Transition(obs=z(C, N, obs_dim), act=z(C, N, act_dim),
                          obs_next=z(C, N, obs_dim), reward=z(C, N),
                          cost=z(C, N, num_costs), terminated=b(),
                          truncated=b(), logp=z(C, N))
        return ReplayBufferState(
            data=data, pos=torch.zeros((), dtype=torch.long, device=dev),
            filled=0)

    # ------------------------------------------------------------------
    def add_segment(self, state: ReplayBufferState,
                    tr: Transition) -> ReplayBufferState:
        """Write a ``(T, N, ...)`` segment at the ring cursor (T <= C):
        rows ``(pos + t) % C``, one indexed copy a field."""
        T, C = tr.reward.shape[0], self.C
        if T > C:
            raise ValueError("segment longer than buffer capacity")
        rows = (state.pos + torch.arange(T, device=state.pos.device)) % C
        for f in dataclasses.fields(Transition):
            getattr(state.data, f.name).index_copy_(0, rows,
                                                    getattr(tr, f.name))
        return ReplayBufferState(data=state.data, pos=(state.pos + T) % C,
                                 filled=min(state.filled + T, C))

    # ------------------------------------------------------------------
    def sample_indices(self, state: ReplayBufferState, batch_size: int,
                       generator: torch.Generator | None = None,
                       rows: Tensor | None = None, envs: Tensor | None = None
                       ) -> tuple[Tensor, Tensor]:
        """Uniform draws over the valid rows of all ``n_envs_total`` envs:
        ``(flat indices row * N + env into this buffer, which of the B
        draws it holds)``. A draw of another shard's env points at this
        buffer's row 0 of the drawn row; one buffer holds every draw.
        ``rows`` (logical, 0 = oldest) and ``envs`` (global) inject the
        draws (tests); otherwise they come from ``generator``."""
        dev = self.device
        if rows is None:
            rows = torch.randint(0, state.filled, (batch_size,),
                                 generator=generator, device=dev)
        if envs is None:
            envs = torch.randint(0, self.n_envs_total, (batch_size,),
                                 generator=generator, device=dev)
        local = envs - self.env_offset
        own = (local >= 0) & (local < self.N)
        local = torch.where(own, local, torch.zeros_like(local))
        # logical row r (0 = oldest) -> physical ring row
        phys = rows if state.filled < self.C else (state.pos + rows) % self.C
        return phys * self.N + local, own

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
        done.index_fill_(0, ((state.pos - 1) % self.C).reshape(1), True)
        return done.reshape(-1)

    def metrics_flat(self, state: ReplayBufferState) -> Tensor:
        """``(C*N, K)`` reward and cost channels of the whole buffer."""
        d = state.data
        m = torch.cat([d.reward[..., None], d.cost], -1)
        return m.reshape(-1, m.shape[-1])
