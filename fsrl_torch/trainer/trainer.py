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

Not ported yet: the device mesh, ``fuse_iters`` and ``rollout_unroll``.
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
    ``algo.init(seed)``."""

    def __init__(self, algo, env: SafeEnv,
                 logger: Optional[BaseLogger] = None, *, epochs: int = 100,
                 step_per_epoch: int = 10000, n_envs: int = 20,
                 steps_per_collect: int = 125, episode_per_test: int = 10,
                 cost_limit: float = 10.0, save_model_interval: int = 1,
                 stop_fn: Optional[Callable[[float, float], bool]] = None,
                 seed: int = 0, verbose: bool = True,
                 resume_from: Optional[str] = None, log_every: int = 1,
                 state=None):
        self.algo, self.env = algo, env
        self.device = algo.device
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
        self.stats = EpisodeStats.init(n_envs, env.num_costs, self.device)

        self.epoch = 0
        self.env_step = 0
        if resume_from:
            # the whole training state, and the step counters from the log
            self.state = load_checkpoint(resume_from, self.state)
            self.epoch, self.env_step, _ = self.logger.restore_data()
        self.best_rew, self.best_cost = -np.inf, np.inf
        self.has_best = False
        self.start_time = time.time()
        # host seconds spent in the epochs' train iterations
        self.collect_time = 0.0
        self.last_metrics: dict = {}

    def _run_iter(self) -> dict:
        raise NotImplementedError

    def test_step(self) -> tuple[float, float, float]:
        out = evaluate(self.env, self.algo.act_fn_eval, self.state.params,
                       self.generator, self.episode_per_test,
                       init_hidden=getattr(self.algo, "init_hidden", None))
        host = {k: float(v) for k, v in out.items()
                if k in ("reward", "cost", "length")}
        self.logger.store(tab="test", **host)
        return host["reward"], host["cost"], host["length"]

    def _save(self, name: str) -> None:
        if self.logger.log_dir:
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
        self.hidden = init_hidden(self.n_envs) if self.recurrent else None

    def _run_iter(self) -> dict:
        res = self.rollout(self.state.params, self.env_state,
                           self.stats.reset_aggregates(), self.generator,
                           hidden=self.hidden)
        if self.recurrent:
            self.state, metrics = self.algo.update(
                self.state, res.transitions, res.init_hidden,
                res.stats.mean_cost, res.stats.n_episodes, self.generator)
            self.hidden = res.hidden
        else:
            self.state, metrics = self.algo.update(
                self.state, res.transitions, res.stats.mean_cost,
                res.stats.n_episodes, self.generator)
        self.env_state, self.stats = res.env_state, res.stats
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

    The buffer holds ``max(buffer_size // n_envs, T)`` rows per env. It is
    not checkpointed (neither is JAX's). ``update_chunk`` is accepted for
    the JAX package's signature: there it groups grad steps into one XLA
    dispatch, here every grad step is issued on its own and the value
    changes nothing. ``fuse_iters`` and the mesh are not ported."""

    def __init__(self, *args, buffer_size: int = 100000,
                 update_per_step: float = 0.2, update_chunk: int = 32,
                 **kwargs):
        super().__init__(*args, **kwargs)
        algo, env = self.algo, self.env
        self.buffer = ReplayBuffer(max(buffer_size // self.n_envs, self.T),
                                   self.n_envs, self.device)
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
                           self.stats.reset_aggregates(), self.generator)
        self.env_state, self.stats = res.env_state, res.stats
        self.buf_state = self.buffer.add_segment(self.buf_state,
                                                 res.transitions)
        self.state = algo.update_lagrangian(self.state, res.stats.mean_cost,
                                            res.stats.n_episodes)
        if hasattr(algo, "pre_update"):
            self.state = algo.pre_update(self.state)
        self.view = make_nstep_view(self.buffer, self.buf_state)

    def update(self) -> dict:
        """The collect's grad steps, then ``post_update``; the last step's
        metrics, as tensors."""
        metrics = {}
        for _ in range(self.n_updates):
            self.state, metrics = self.algo.update_step(
                self.state, self.buffer, self.buf_state, self.generator,
                view=self.view)
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
