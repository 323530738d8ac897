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

Dispatch settings: where the JAX trainers put several steps into one
compiled dispatch, the port replays a CUDA graph of the eager code on the
card (:mod:`fsrl_torch.trainer.graphs`), with the results of the eager
code:

* ``fuse_iters`` = k (both trainers): k collect-and-update cycles a
  dispatch, one graph; an epoch counts ``T * n_envs * k`` env steps a
  dispatch, and the train metrics and episode statistics are the last
  cycle's;
* ``update_chunk`` (off-policy): the collect's grad steps in JAX's
  ``chunk_sizes``, each chunk of more than one step one graph;
* ``rollout_unroll`` = u (on-policy, with ``fuse_iters`` 1): the rollout
  in graphs of u env steps.

The first dispatch of each graph runs eagerly, as its warm-up. On the CPU
these settings change nothing but the step accounting. Under a mesh the k
cycles and the chunks run one after another without a graph: gloo's
collectives pass through the host. ``dispatch_mode`` says which, and
each trainer logs it once built (an INFO line on this module's logger).
Unlike JAX, which splits a key for each chunk, the port draws from one
generator in sequence, so ``update_chunk`` does not change its results.
"""

from __future__ import annotations

import logging
import os.path as osp
import time
from functools import partial
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
from fsrl_torch.trainer.graphs import Dispatch
from fsrl_torch.types import EpisodeStats
from fsrl_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from fsrl_torch.utils.logger import BaseLogger, DummyLogger

_log = logging.getLogger(__name__)


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
    :func:`make_mesh`) trains data parallel over its ranks. Each dispatch
    runs ``fuse_iters`` cycles (:meth:`cycle`); the attributes named in
    ``CARRY`` are what a cycle replaces, and what a graph of the dispatch
    carries."""

    CARRY = ("state", "env_state", "stats")

    def __init__(self, algo, env: SafeEnv,
                 logger: Optional[BaseLogger] = None, *, epochs: int = 100,
                 step_per_epoch: int = 10000, n_envs: int = 20,
                 steps_per_collect: int = 125, episode_per_test: int = 10,
                 cost_limit: float = 10.0, save_model_interval: int = 1,
                 stop_fn: Optional[Callable[[float, float], bool]] = None,
                 mesh=None, use_default_mesh: bool = False,
                 seed: int = 0, verbose: bool = True,
                 resume_from: Optional[str] = None, log_every: int = 1,
                 state=None, fuse_iters: int = 1):
        self.algo, self.env = algo, env
        self.fuse_iters = max(1, int(fuse_iters))
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
        # the graph of a whole dispatch, where there is one
        self.graph: Dispatch | None = None
        self.dispatch_mode = "eager"

    def _graphs_off(self) -> str:
        """Why this trainer replays no graph whatever its settings, or ''
        if it may."""
        if self.device.type != "cuda":
            return "on the CPU"
        if self.dp is not None:
            return "data parallel: gloo's collectives pass through the host"
        return ""

    def _fuse_graph(self) -> None:
        """With ``fuse_iters`` > 1 on the card, the graph of a dispatch."""
        off = self._graphs_off()
        if self.fuse_iters > 1 and not off:
            self.graph = Dispatch(self._cycles, (self.generator,),
                                  name=f"{self.fuse_iters} cycles")
            self.dispatch_mode = f"graph of {self.fuse_iters} cycles"
        elif self.fuse_iters > 1:
            self.dispatch_mode = f"eager ({off})"

    def _log_mode(self) -> None:
        _log.info("%s %d envs x %d steps, fuse_iters %d: %s",
                  type(self).__name__, self.n_envs, self.T, self.fuse_iters,
                  self.dispatch_mode)

    def cycle(self) -> dict:
        """One collect and update, eagerly: the work a dispatch repeats
        ``fuse_iters`` times. Returns the metrics as tensors."""
        raise NotImplementedError

    def _cycles(self, carry: tuple) -> tuple[tuple, dict]:
        """``fuse_iters`` cycles from ``carry`` (the ``CARRY``
        attributes): the new carry and the last cycle's metrics."""
        for name, value in zip(self.CARRY, carry):
            setattr(self, name, value)
        for _ in range(self.fuse_iters):
            metrics = self.cycle()
        return tuple(getattr(self, name) for name in self.CARRY), metrics

    def _run_iter(self) -> dict:
        """One dispatch: ``fuse_iters`` cycles, replayed from the graph
        where there is one; then the train log."""
        run = self._cycles if self.graph is None else self.graph
        carry, metrics = run(tuple(getattr(self, n) for n in self.CARRY))
        for name, value in zip(self.CARRY, carry):
            setattr(self, name, value)
        self._log_train(self.stats, metrics)
        return metrics

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
        steps_per_iter = self.T * self.n_envs * self.fuse_iters
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
    state carries across the collects.

    ``fuse_iters`` = k runs k cycles a dispatch, on the card from one CUDA
    graph; ``rollout_unroll`` = u > 1 with ``fuse_iters`` 1 runs the
    rollout in graphs of u env steps on the card (the module's
    docstring)."""

    CARRY = ("state", "env_state", "stats", "hidden")

    def __init__(self, *args, rollout_unroll: int = 1, **kwargs):
        super().__init__(*args, **kwargs)
        self.rollout_unroll = max(1, int(rollout_unroll))
        init_hidden = getattr(self.algo, "init_hidden", None)
        self.recurrent = init_hidden is not None
        self._fuse_graph()
        unroll = 1
        if self.fuse_iters == 1 and self.rollout_unroll > 1:
            off = self._graphs_off()
            unroll = 1 if off else self.rollout_unroll
            self.dispatch_mode = (f"eager ({off})" if off else
                                  f"eager; rollout in graphs of {unroll} "
                                  f"steps")
        self.rollout = make_rollout_fn(self.env, self.algo.act_fn, self.T,
                                       self.device, init_hidden=init_hidden,
                                       unroll=unroll)
        # the fresh carry is zeros, so the rank's block of it is its own
        self.hidden = init_hidden(self.n_local) if self.recurrent else None
        self._log_mode()

    def cycle(self) -> dict:
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
        return metrics


class OffpolicyTrainer(BaseTrainer):
    """Collect a segment into the ring replay buffer, then run
    ``n_updates = max(1, round(update_per_step * T * N))`` grad steps on
    batches sampled from it (port of ``OffpolicyTrainerTPU``). Per collect,
    in the JAX package's order: rollout, ``add_segment``,
    ``update_lagrangian``, ``pre_update`` (where the algorithm has one),
    the n-step view, the grad steps, ``post_update``. The train metrics are
    the last grad step's.

    The grad steps go in JAX's ``chunk_sizes``: ``update_chunk`` clamped to
    ``[1, n_updates]``, repeated, then the remainder. On the card each chunk
    of more than one step replays a CUDA graph, captured once for each
    fill count of the buffer until it is full; with ``fuse_iters`` = k > 1
    the k whole cycles are one graph instead.

    The buffer holds ``max(buffer_size // n_envs, T)`` rows per env (under
    a mesh each rank the columns of its envs). It is not checkpointed
    (neither is JAX's)."""

    CARRY = ("state", "env_state", "stats", "buf_state")

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
        chunk = max(1, min(self.n_updates, int(update_chunk)))
        self.chunk_sizes = [chunk] * (self.n_updates // chunk)
        if self.n_updates % chunk:
            self.chunk_sizes.append(self.n_updates % chunk)
        self.rollout = make_rollout_fn(env, algo.act_fn, self.T, self.device)
        self.view = None
        self._fuse_graph()
        # n -> the graph of a chunk of n grad steps
        self.chunk_graphs: dict[int, Dispatch] = {}
        off = self._graphs_off()
        if self.fuse_iters == 1 and not off:
            self.chunk_graphs = {
                n: Dispatch(partial(self._grad_steps, n=n),
                            (self.generator,), name=f"{n} grad steps")
                for n in sorted(set(self.chunk_sizes)) if n > 1}
            if self.chunk_graphs:
                self.dispatch_mode = (
                    "eager collect; grad steps in graphs of "
                    + ", ".join(map(str, self.chunk_graphs)))
        elif self.fuse_iters == 1 and chunk > 1:
            self.dispatch_mode = f"eager ({off})"
        self._log_mode()

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

    def _grad_steps(self, state, buf_state, view, n: int):
        """``n`` grad steps from ``state``: the new state and the last
        step's metrics."""
        dp = {} if self.dp is None else dict(dp=self.dp)
        metrics = {}
        for _ in range(n):
            state, metrics = self.algo.update_step(
                state, self.buffer, buf_state, self.generator, view=view,
                **dp)
        return state, metrics

    def update(self) -> dict:
        """The collect's grad steps, chunk by chunk (each from its graph
        where it has one), then ``post_update``; the last step's metrics,
        as tensors."""
        metrics = {}
        for n in self.chunk_sizes:
            run = self.chunk_graphs.get(n) or partial(self._grad_steps, n=n)
            self.state, metrics = run(self.state, self.buf_state, self.view)
        if hasattr(self.algo, "post_update"):
            self.state = self.algo.post_update(self.state)
        return metrics

    def cycle(self) -> dict:
        self.collect()
        return self.update()


def onpolicy_trainer(*args, **kwargs) -> dict:
    """Functional wrapper: ``OnpolicyTrainer(*args, **kwargs).run()``
    (reference ``fsrl/trainer/onpolicy.py:113-120``)."""
    return OnpolicyTrainer(*args, **kwargs).run()


def offpolicy_trainer(*args, **kwargs) -> dict:
    """Functional wrapper: ``OffpolicyTrainer(*args, **kwargs).run()``
    (reference ``fsrl/trainer/offpolicy.py:109-116``)."""
    return OffpolicyTrainer(*args, **kwargs).run()
