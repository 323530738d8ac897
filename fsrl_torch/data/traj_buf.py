"""Trajectory buffer for offline safe-RL datasets (port of
``fsrl_tpu/data/traj_buf.py``).

An episode-level store: episodes whose reward and cost returns fall in the
acceptance ranges are kept; over capacity, a grid filter over the 2-D
(reward return, cost return) space keeps a spatially uniform subsample
(reference ``fsrl/data/traj_buf.py:97-161``); the dataset exports to HDF5
in the D4RL / DSRL schema.

``store_segment`` takes a time-major ``(T, N)`` rollout
:class:`fsrl_torch.types.Transition` (on any device), moves it to the host
once and slices it into finished episodes per env column, carrying partial
episodes over segment boundaries.

The filter is the C++ one (:mod:`fsrl_torch.native`, seed 0, as in JAX);
:meth:`TrajectoryBuffer.filter_points` is its plain numpy version. Random
draws (the replacement of a full buffer without the filter, ``sample``)
come from the buffer's ``np.random.Generator``. The dataset is written and
read by :mod:`fsrl_torch.data.hdf5` (numpy alone, no h5py): the JAX
package's keys, dtypes and shapes in one HDF5 file that h5py reads, each
array stored contiguous where the JAX package compresses it with gzip.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Optional

import numpy as np
import torch

from fsrl_torch.data.hdf5 import read_datasets, write_datasets
from fsrl_torch.native import grid_filter_native

KEYS = ("observations", "next_observations", "actions", "rewards", "costs",
        "terminals", "timeouts")


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


class TrajectoryBuffer:
    """Episode-level store for offline dataset generation: return-range
    acceptance, the 2-D grid density filter, HDF5 export."""

    def __init__(
        self,
        max_trajectory: int = 99999,
        use_grid_filter: bool = True,
        rmin: float = -np.inf,
        rmax: float = np.inf,
        cmin: float = -np.inf,
        cmax: float = np.inf,
        filter_interval: float = 2.0,
        rng: Optional[np.random.Generator] = None,
    ):
        self.max_trajectory = max_trajectory
        self.buffer: list[dict[str, np.ndarray]] = []
        self.metrics: list[np.ndarray] = []
        self.rmin, self.rmax = rmin, rmax
        self.cmin, self.cmax = cmin, cmax
        self.use_grid_filter = use_grid_filter
        if use_grid_filter:
            if filter_interval <= 1:
                raise ValueError("filter interval must be > 1")
            self.filtering_thres = int(filter_interval * max_trajectory)
        self.rng = np.random.default_rng(0) if rng is None else rng
        self._partial: dict[int, list[dict[str, np.ndarray]]] = \
            defaultdict(list)

    # ------------------------------------------------------------------
    def store_segment(self, tr) -> int:
        """Absorb a ``(T, N, ...)`` rollout Transition; returns the number
        of episodes it finished."""
        obs = _host(tr.obs)
        T, N = obs.shape[:2]
        step = dict(
            observations=obs,
            next_observations=_host(tr.obs_next),
            actions=_host(tr.act),
            rewards=_host(tr.reward),
            costs=_host(tr.cost).sum(-1),
            terminals=_host(tr.terminated),
            timeouts=_host(tr.truncated),
        )
        done = step["terminals"] | step["timeouts"]
        n_done = 0
        for n in range(N):
            start = 0
            for t in range(T):
                if done[t, n]:
                    chunk = {k: v[start:t + 1, n] for k, v in step.items()}
                    self._partial[n].append(chunk)
                    self._finish_episode(n)
                    n_done += 1
                    start = t + 1
            if start < T:
                self._partial[n].append(
                    {k: v[start:, n] for k, v in step.items()})
        return n_done

    def _finish_episode(self, env_idx: int) -> None:
        chunks = self._partial.pop(env_idx, [])
        if not chunks:
            return
        traj = {k: np.concatenate([c[k] for c in chunks]) for k in KEYS}
        rew, cost = float(traj["rewards"].sum()), float(traj["costs"].sum())
        if not (self.rmin <= rew <= self.rmax
                and self.cmin <= cost <= self.cmax):
            return
        if len(self.buffer) < self.max_trajectory:
            self.buffer.append(traj)
            self.metrics.append(np.array([rew, cost]))
        elif self.use_grid_filter:
            self.buffer.append(traj)
            self.metrics.append(np.array([rew, cost]))
            if len(self.buffer) >= self.filtering_thres:
                self.apply_grid_filter()
        else:
            i = int(self.rng.integers(0, len(self.buffer)))
            self.buffer[i] = traj
            self.metrics[i] = np.array([rew, cost])

    # ------------------------------------------------------------------
    def apply_grid_filter(self) -> None:
        """Downsample to ``max_trajectory`` episodes, keeping the (reward,
        cost) coverage uniform (reference ``traj_buf.py:97-117``), with the
        C++ filter at seed 0."""
        kept = set(grid_filter_native(np.asarray(self.metrics),
                                      self.max_trajectory, seed=0))
        w = 0
        for r in range(len(self.buffer)):
            if r in kept:
                if r != w:
                    self.buffer[w] = self.buffer[r]
                    self.metrics[w] = self.metrics[r]
                w += 1
        del self.buffer[w:]
        del self.metrics[w:]

    @staticmethod
    def filter_points(points, target_size: int,
                      rng: Optional[np.random.Generator] = None) -> list:
        """The grid filter's plain numpy version: bucket the 2-D points on
        a ~sqrt(target)-per-side grid over their bounding box and select
        breadth-first by depth within the cell, so every occupied cell
        gives one point before any cell gives two; the order within a cell
        and the ties across cells at equal depth are random (``rng``)."""
        pts = np.asarray(points, dtype=np.float64)
        n = pts.shape[0]
        if n <= target_size:
            return list(range(n))
        g = int(np.ceil(np.sqrt(target_size)))
        lo, hi = pts.min(axis=0), pts.max(axis=0)
        span = np.maximum(hi - lo, 1e-12)
        cell_xy = np.minimum((pts - lo) / span * g, g).astype(np.int64)
        cid = cell_xy[:, 0] * (g + 1) + cell_xy[:, 1]

        rng = np.random.default_rng() if rng is None else rng
        shuffle = rng.permutation(n)            # random order within a cell
        by_cell = shuffle[np.argsort(cid[shuffle], kind="stable")]
        sorted_cid = cid[by_cell]
        # depth of each point within its cell (0: the cell's first pick)
        new_cell = np.r_[True, sorted_cid[1:] != sorted_cid[:-1]]
        pos = np.arange(n)
        cell_start = pos[new_cell][np.cumsum(new_cell) - 1]
        depth = pos - cell_start
        # breadth-first: every depth-0 point (one per occupied cell) ranks
        # ahead of any depth-1 point; ties at equal depth break randomly
        pick = np.lexsort((rng.random(n), depth))[:target_size]
        return by_cell[pick].tolist()

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return sum(len(t["rewards"]) for t in self.buffer)

    @property
    def num_trajectories(self) -> int:
        return len(self.buffer)

    def sample(self, batch_size: int) -> dict[str, np.ndarray]:
        tis = self.rng.integers(0, len(self.buffer), size=batch_size)
        out = defaultdict(list)
        for ti in tis:
            traj = self.buffer[ti]
            si = int(self.rng.integers(0, len(traj["rewards"])))
            for k in KEYS:
                out[k].append(traj[k][si])
        return {k: np.stack(v) for k, v in out.items()}

    def get_all(self) -> dict[str, np.ndarray]:
        return {k: np.concatenate([t[k] for t in self.buffer])
                for k in KEYS}

    def save(self, log_dir: str, dataset_name: str = "dataset.hdf5") -> str:
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, dataset_name)
        write_datasets(path, self.get_all())
        return path

    @staticmethod
    def load(path: str) -> dict[str, np.ndarray]:
        """The arrays of a dataset :meth:`save` wrote."""
        return read_datasets(path)
