"""Epoch-driven on-policy training loop (port of the feedforward, single
device part of ``fsrl_tpu/trainer/trainer.py``).

The inner loop collects a segment and updates the policy until
``step_per_epoch`` env steps, then runs the episode-exact test, keeps the
feasibility-first best result and checks ``stop_fn``. All collect and
update work stays on the device; the host reads metrics back once every
``log_every`` iterations, in one transfer.

Every ``save_model_interval`` epochs the whole training state is written
to ``<log_dir>/checkpoint/model.pt``, and the feasibility-first best one to
``model_best.pt``; ``resume_from`` restores a state and the logger's step
counters.

``OffpolicyTrainer`` keeps a ring replay buffer on the device and runs
``round(update_per_step * T * N)`` sampled grad steps per collect.

A recurrent algorithm (one with ``init_hidden``, e.g.
:class:`fsrl_torch.algos.ppo_lag_rnn.RecurrentPPOLag`) keeps its hidden
state across collects, and its update gets the carry at the segment's
start.

Data parallel (``mesh=``, a ``DeviceMesh`` from
:func:`fsrl_torch.parallel.mesh.make_mesh`, one process per card): each
rank steps its block of the ``n_envs`` envs (global, divisible by the
ranks) with its share of the recurrent carry and of the replay buffer,
draws everything from a generator seeded alike on every rank, merges the
collect's episode statistics over the ranks before the update reads them,
and passes ``dp`` to the update, which sums gradients over the ranks
(:mod:`fsrl_torch.parallel.mesh`). The episode-exact test runs on rank 0,
whose results and generator state are broadcast before the best result and
``stop_fn`` are decided, so every rank leaves the loop together; rank 0
alone writes the logger and the checkpoints; ``resume_from`` loads on every
rank, and the step counters come from rank 0's logger.

Not ported yet: ``fuse_iters``, ``rollout_unroll`` and a working
``update_chunk``.
"""

from __future__ import annotations

import os.path as osp
import time
from typing import Callable, Optional

import numpy as np
import torch

from fsrl_torch.algos.offpolicy_base import make_nstep_view
from fsrl_torch.data.buffer import ReplayBuffer
from fsrl_torch.data.collector import evaluate, make_rollout_fn
from fsrl_torch.envs.base import SafeEnv
from fsrl_torch.parallel.mesh import (DPGroup, EnvRows, check_rank_device,
                                      make_mesh, replicate_tree,
                                      shard_env_state)
from fsrl_torch.types import EpisodeStats
from fsrl_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from fsrl_torch.utils.logger import BaseLogger, DummyLogger


def perf_is_better(new_rew, new_cost, old_rew, old_cost, cost_limit) -> bool:
    """Feasibility-first comparison: a feasible policy (every cost within its
    limit) beats any infeasible one; within one feasibility class the higher
    reward wins. ``cost_limit`` is a scalar or per-constraint list; scalar
    costs compare against the sum of the limits."""
    limit = np.atleast_1d(np.asarray(cost_limit, dtype=float))

    def feasible(c):
        c = np.atleast_1d(np.asarray(c, dtype=float))
        if c.shape != limit.shape:
            return float(np.sum(c)) <= float(np.sum(limit))
        return bool(np.all(c <= limit))

    new_feas, old_feas = feasible(new_cost), feasible(old_cost)
    if new_feas and not old_feas:
        return True
    if old_feas and not new_feas:
        return False
    return new_rew > old_rew


class BaseTrainer:
    """Epoch iterator: train iterations up to ``step_per_epoch``, then the
    episode-exact test, best-result tracking, ``stop_fn`` and speed
    counters. ``state`` may be passed in (the agent does); otherwise it is
    ``algo.init(seed)``. ``mesh`` (or ``use_default_mesh``, which builds
    :func:`make_mesh`) trains data parallel over its ranks."""

    def __init__(self, algo, env: SafeEnv,
                 logger: Optional[BaseLogger] = None, *, epochs: int = 100,
                 step_per_epoch: int = 10000, n_envs: int = 20,
                 steps_per_collect: int = 125, episode_per_test: int = 10,
                 cost_limit: float = 10.0, save_model_interval: int = 1,
                 stop_fn: Optional[Callable[[float, float], bool]] = None,
                 mesh=None, use_default_mesh: bool = False,
                 seed: int = 0, verbose: bool = True,
                 resume_from: Optional[str] = None, log_every: int = 1,
                 state=None):
        self.algo, self.env = algo, env
        self.device = algo.device
        self.mesh = mesh or (make_mesh() if use_default_mesh else None)
        self.dp = None if self.mesh is None else DPGroup.of(self.mesh)
        self.rank0 = self.dp is None or self.dp.rank == 0
        self.logger = logger or DummyLogger()
        self.epochs, self.step_per_epoch = epochs, step_per_epoch
        self.n_envs, self.T = n_envs, steps_per_collect
        self.episode_per_test = episode_per_test
        self.cost_limit = cost_limit
        self.save_model_interval = save_model_interval
        self.stop_fn = stop_fn
        self.verbose = verbose
        self.log_every = max(1, int(log_every))
        self._iter_count = 0

        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.state = algo.init(seed) if state is None else state
        # staggered episode clocks: a steady stream of finished episodes
        # for the PID multiplier instead of lockstep truncation bursts
        self.env_state = env.reset_vec(n_envs, self.generator, stagger=True)
        # what the rollout draws from: the generator, or under a mesh the
        # generator cut to this rank's envs
        self.draw = self.generator
        self.n_local = n_envs
        if self.dp is not None:
            lo, hi = self.dp.block(n_envs)
            self.n_local = hi - lo
            check_rank_device(self.state)
            self.env_state = shard_env_state(self.mesh, self.env_state)
            self.state = replicate_tree(self.mesh, self.state)
            self.draw = EnvRows(self.generator, n_envs, lo, hi)
        self.stats = EpisodeStats.init(self.n_local, env.num_costs,
                                       self.device)

        self.epoch = 0
        self.env_step = 0
        if resume_from:
            # the whole training state, and the step counters from the log
            self.state = load_checkpoint(resume_from, self.state)
            counters = list(self.logger.restore_data()[:2])
            if self.dp is not None:
                counters = self.dp.share_from_rank0(
                    counters, self.generator, self.device)
            self.epoch, self.env_step = (int(c) for c in counters)
        if not self.rank0:
            self.logger = DummyLogger()
        self.best_rew, self.best_cost = -np.inf, np.inf
        self.has_best = False
        self.start_time = time.time()
        # host seconds spent in the epochs' train iterations
        self.collect_time = 0.0
        self.last_metrics: dict = {}

    def _run_iter(self) -> dict:
        raise NotImplementedError

    def test_step(self) -> tuple[float, float, float]:
        """The episode-exact test; under a mesh on rank 0, whose results
        and generator state every rank then takes."""
        vals = [0.0] * 3
        if self.rank0:
            out = evaluate(
                self.env, self.algo.act_fn_eval, self.state.params,
                self.generator, self.episode_per_test,
                init_hidden=getattr(self.algo, "init_hidden", None))
            vals = torch.stack([out["reward"], out["cost"],
                                out["length"]]).tolist()
        if self.dp is not None:
            vals = self.dp.share_from_rank0(vals, self.generator,
                                            self.device)
        rew, cost, length = vals
        self.logger.store(tab="test", reward=rew, cost=cost, length=length)
        return rew, cost, length

    def _save(self, name: str) -> None:
        if self.logger.log_dir and self.rank0:
            save_checkpoint(
                osp.join(self.logger.log_dir, "checkpoint", name), self.state)

    def checkpoint(self) -> None:
        self._save("model.pt")

    def checkpoint_best(self) -> None:
        self._save("model_best.pt")

    def __iter__(self):
        return self

    def __next__(self):
        if self.epoch >= self.epochs:
            raise StopIteration
        self.epoch += 1
        t0 = time.time()
        steps_this_epoch = 0
        steps_per_iter = self.T * self.n_envs
        while steps_this_epoch < self.step_per_epoch:
            self._run_iter()
            steps_this_epoch += steps_per_iter
            self.env_step += steps_per_iter
        self.collect_time += time.time() - t0

        rew, cost, length = self.test_step()
        if perf_is_better(rew, cost, self.best_rew, self.best_cost,
                          self.cost_limit) or not self.has_best:
            self.best_rew, self.best_cost = rew, cost
            self.has_best = True
            self.checkpoint_best()
        if self.epoch % self.save_model_interval == 0:
            self.checkpoint()

        dur = time.time() - self.start_time
        speed = self.env_step / max(dur, 1e-9)
        self.logger.store(tab="update", env_step=self.env_step, speed=speed,
                          duration=dur, epoch=self.epoch,
                          gradient_step=int(self.state.gradient_steps))
        info = dict(epoch=self.epoch, env_step=self.env_step,
                    best_reward=self.best_rew, best_cost=self.best_cost,
                    test_reward=rew, test_cost=cost, test_length=length,
                    speed=speed)
        epoch_stats = dict(self.logger.stats_mean())
        self.logger.write(self.env_step, display=self.verbose)

        if self.stop_fn and self.stop_fn(self.best_rew, self.best_cost):
            self.epoch = self.epochs
        return self.epoch, epoch_stats, info

    def run(self) -> dict:
        info = {}
        for _, _, info in self:
            pass
        return info

    def _log_train(self, stats: EpisodeStats, metrics: dict) -> None:
        """Every ``log_every`` iterations, one device-to-host transfer of
        the collect's episodic statistics and the update's metrics."""
        self._iter_count += 1
        if self._iter_count % self.log_every:
            return
        names = list(metrics)
        vals = torch.stack(
            [stats.n_episodes.float(), stats.mean_reward,
             stats.mean_cost.sum(), stats.mean_length]
            + [metrics[k].float().reshape(()) for k in names]).tolist()
        n_ep, rew, cost, length = vals[:4]
        if n_ep > 0:
            self.logger.store(tab="train", reward=rew, cost=cost,
                              length=length, num_episodes=int(n_ep))
        self.last_metrics = dict(zip(names, vals[4:]))
        for k, v in self.last_metrics.items():
            tab, name = k.split("/", 1)
            self.logger.store(tab=tab, **{name: v})


class OnpolicyTrainer(BaseTrainer):
    """Collect a segment, step the PID multiplier, update the policy on the
    whole segment: the on-policy schedule. A recurrent algorithm's hidden
    state carries across the collects."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        init_hidden = getattr(self.algo, "init_hidden", None)
        self.recurrent = init_hidden is not None
        self.rollout = make_rollout_fn(self.env, self.algo.act_fn, self.T,
                                       self.device, init_hidden=init_hidden)
        # the fresh carry is zeros, so the rank's block of it is its own
        self.hidden = init_hidden(self.n_local) if self.recurrent else None

    def _run_iter(self) -> dict:
        res = self.rollout(self.state.params, self.env_state,
                           self.stats.reset_aggregates(), self.draw,
                           hidden=self.hidden)
        stats = res.stats
        if self.dp is not None:
            stats = stats.merge_across(self.dp)
        dp = {} if self.dp is None else dict(dp=self.dp)
        if self.recurrent:
            self.state, metrics = self.algo.update(
                self.state, res.transitions, res.init_hidden,
                stats.mean_cost, stats.n_episodes, self.generator, **dp)
            self.hidden = res.hidden
        else:
            self.state, metrics = self.algo.update(
                self.state, res.transitions, stats.mean_cost,
                stats.n_episodes, self.generator, **dp)
        self.env_state, self.stats = res.env_state, stats
        self._log_train(self.stats, metrics)
        return metrics


class OffpolicyTrainer(BaseTrainer):
    """Collect a segment into the ring replay buffer, then run
    ``n_updates = max(1, round(update_per_step * T * N))`` grad steps on
    batches sampled from it (port of ``OffpolicyTrainerTPU``). Per collect,
    in the JAX package's order: rollout, ``add_segment``,
    ``update_lagrangian``, ``pre_update`` (where the algorithm has one),
    the n-step view, the grad steps, ``post_update``. The train metrics are
    the last grad step's.

    The buffer holds ``max(buffer_size // n_envs, T)`` rows per env (under
    a mesh each rank the columns of its envs). It is not checkpointed
    (neither is JAX's). ``update_chunk`` is accepted for the JAX package's
    signature: there it groups grad steps into one XLA dispatch, here every
    grad step is issued on its own and the value changes nothing.
    ``fuse_iters`` is not ported."""

    def __init__(self, *args, buffer_size: int = 100000,
                 update_per_step: float = 0.2, update_chunk: int = 32,
                 **kwargs):
        super().__init__(*args, **kwargs)
        algo, env = self.algo, self.env
        self.buffer = ReplayBuffer(
            max(buffer_size // self.n_envs, self.T), self.n_local,
            self.device, n_envs_total=self.n_envs,
            env_offset=0 if self.dp is None else self.dp.block(
                self.n_envs)[0])
        self.buf_state = self.buffer.init(env.observation_size,
                                          env.action_size, env.num_costs)
        self.n_updates = max(1, int(round(update_per_step * self.T
                                          * self.n_envs)))
        self.rollout = make_rollout_fn(env, algo.act_fn, self.T, self.device)
        self.view = None

    def collect(self) -> None:
        """Rollout, buffer write, the per-collect hooks and the n-step
        view."""
        algo = self.algo
        res = self.rollout(self.state.params, self.env_state,
                           self.stats.reset_aggregates(), self.draw)
        stats = res.stats
        if self.dp is not None:
            stats = stats.merge_across(self.dp)
        self.env_state, self.stats = res.env_state, stats
        self.buf_state = self.buffer.add_segment(self.buf_state,
                                                 res.transitions)
        self.state = algo.update_lagrangian(self.state, stats.mean_cost,
                                            stats.n_episodes)
        if hasattr(algo, "pre_update"):
            self.state = algo.pre_update(self.state)
        self.view = make_nstep_view(self.buffer, self.buf_state)

    def update(self) -> dict:
        """The collect's grad steps, then ``post_update``; the last step's
        metrics, as tensors."""
        metrics = {}
        dp = {} if self.dp is None else dict(dp=self.dp)
        for _ in range(self.n_updates):
            self.state, metrics = self.algo.update_step(
                self.state, self.buffer, self.buf_state, self.generator,
                view=self.view, **dp)
        if hasattr(self.algo, "post_update"):
            self.state = self.algo.post_update(self.state)
        return metrics

    def _run_iter(self) -> dict:
        self.collect()
        metrics = self.update()
        self._log_train(self.stats, metrics)
        return metrics


def onpolicy_trainer(*args, **kwargs) -> dict:
    """Functional wrapper: ``OnpolicyTrainer(*args, **kwargs).run()``
    (reference ``fsrl/trainer/onpolicy.py:113-120``)."""
    return OnpolicyTrainer(*args, **kwargs).run()


def offpolicy_trainer(*args, **kwargs) -> dict:
    """Functional wrapper: ``OffpolicyTrainer(*args, **kwargs).run()``
    (reference ``fsrl/trainer/offpolicy.py:109-116``)."""
    return OffpolicyTrainer(*args, **kwargs).run()
