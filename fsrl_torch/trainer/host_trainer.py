"""Training loops over host environments (port of
``fsrl_tpu/trainer/host_trainer.py``).

The env steps run on host threads (:class:`fsrl_torch.envs.host_env.
HostVectorEnv`); each collected ``(T, N)`` segment goes to the card once
and feeds the same ``algo.update`` (on-policy) or replay buffer and
``update_step`` loop (off-policy) as the batched-env trainers, so the
kernels run as they do there.

Per-step actions come from a CPU copy of the parameters, refreshed once
after every update, with a CPU generator: one device-to-host transfer a
collect instead of one round trip to the card per env step (the JAX
package's inference copy). The updates draw from a generator on the card.

Two behaviours of the JAX reference are kept as they are (ROADMAP §C):

* at a done step ``obs_next`` holds the next episode's first observation,
  because the reset observation is written into the array the segment
  already holds; a truncated episode then bootstraps from the reset state;
* the test collect runs on the training envs unless ``test_venv`` is
  given, and resets them, so the trainer's observation and episode sums
  are stale for the next collect.
"""

from __future__ import annotations

import copy
import os.path as osp
import time
from typing import Callable, Optional

import numpy as np
import torch

from fsrl_torch.algos.offpolicy_base import make_nstep_view
from fsrl_torch.data.buffer import ReplayBuffer
from fsrl_torch.envs.host_env import HostCollector, HostVectorEnv, \
    host_actions
from fsrl_torch.trainer.trainer import perf_is_better
from fsrl_torch.types import Transition
from fsrl_torch.utils.checkpoint import save_checkpoint
from fsrl_torch.utils.logger import BaseLogger, DummyLogger


def host_copy(params: torch.nn.Module) -> torch.nn.Module:
    """An independent CPU copy of a parameter module, for per-step
    inference on the host."""
    return copy.deepcopy(params).to("cpu")


class HostOnpolicyTrainer:
    """On-policy trainer over host envs: host rollout of ``T`` steps across
    the ``N`` envs with the CPU inference copy, then one whole-segment
    ``algo.update`` on the algorithm's device.

    ``collect_split`` holds the last collect's host seconds in the env
    (steps and resets), in the policy (forward and conversion) and in
    building the segment on the device."""

    def __init__(
        self,
        algo,
        venv: HostVectorEnv,
        test_venv: Optional[HostVectorEnv] = None,
        logger: Optional[BaseLogger] = None,
        *,
        epochs: int = 100,
        step_per_epoch: int = 10000,
        steps_per_collect: int = 500,
        episode_per_test: int = 4,
        cost_limit: float = 10.0,
        save_model_interval: int = 4,
        stop_fn: Optional[Callable[[float, float], bool]] = None,
        seed: int = 0,
        verbose: bool = True,
    ):
        if type(self) is HostOnpolicyTrainer and not hasattr(algo, "update"):
            raise TypeError(
                f"{type(algo).__name__} is an off-policy algorithm (no "
                "whole-segment update): use HostOffpolicyTrainer")
        self.algo, self.venv = algo, venv
        self.device = algo.device
        self.test_venv = test_venv or venv
        self.logger = logger or DummyLogger()
        self.epochs, self.step_per_epoch = epochs, step_per_epoch
        self.T = steps_per_collect
        self.episode_per_test = episode_per_test
        self.cost_limit = cost_limit
        # kept for the JAX signature; like it, the loop writes only the
        # best checkpoint
        self.save_model_interval = save_model_interval
        self.stop_fn = stop_fn
        self.verbose = verbose

        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.host_generator = torch.Generator().manual_seed(seed)
        self.state = algo.init(seed)
        self.act_fn, self.act_fn_eval = algo.act_fn, algo.act_fn_eval
        self._host_params = None
        self.obs = venv.reset(seed=seed)
        self.ep_r = np.zeros(venv.n)
        self.ep_c = np.zeros(venv.n)
        self.epoch = 0
        self.env_step = 0
        self.best_rew, self.best_cost = -np.inf, np.inf
        self.has_best = False
        self.start_time = time.time()
        self.collector = HostCollector(self.test_venv)
        self.last_metrics: dict = {}
        self.collect_split = {"env": 0.0, "act": 0.0, "transfer": 0.0}

    # ------------------------------------------------------------------
    def _inference_params(self):
        """The parameters for per-step inference: a CPU copy, made again
        after every update; on a CPU algorithm the parameters
        themselves."""
        if self.device.type == "cpu":
            return self.state.params
        if self._host_params is None:
            self._host_params = host_copy(self.state.params)
        return self._host_params

    def collect_segment(self) -> tuple[Transition, torch.Tensor,
                                       torch.Tensor]:
        """``T`` host steps across the ``N`` envs → (a time-major
        ``Transition`` on the algorithm's device, the mean episodic cost
        of the episodes that ended, shape (1,), their number)."""
        venv, T = self.venv, self.T
        obs_l, act_l, obsn_l, rew_l, cost_l, term_l, trunc_l, logp_l = \
            ([] for _ in range(8))
        sum_c, n_ep = 0.0, 0
        t_act = t_env = 0.0
        params = self._inference_params()
        for _ in range(T):
            t0 = time.perf_counter()
            act, logp = host_actions(self.act_fn, params, self.obs,
                                     self.host_generator)
            t1 = time.perf_counter()
            obs_n, rew, cost, term, trunc = venv.step(venv.scale_action(act))
            obs_l.append(self.obs)
            act_l.append(act)
            obsn_l.append(obs_n)
            rew_l.append(rew)
            cost_l.append(cost)
            term_l.append(term)
            trunc_l.append(trunc)
            logp_l.append(logp)
            self.ep_r += rew
            self.ep_c += cost
            done = term | trunc
            for i in np.nonzero(done)[0]:
                sum_c += self.ep_c[i]
                n_ep += 1
                self.logger.store(tab="train", reward=self.ep_r[i],
                                  cost=self.ep_c[i])
                self.ep_r[i] = self.ep_c[i] = 0.0
                # obs_n is also the segment's obs_next row (as in JAX)
                obs_n[i] = venv.reset(ids=[i])[0]
            self.obs = obs_n
            t_act += t1 - t0
            t_env += time.perf_counter() - t1
        t0 = time.perf_counter()
        dev = self.device

        def put(rows, dtype=None):
            x = torch.from_numpy(np.stack(rows))
            return x.to(device=dev, dtype=dtype or x.dtype)

        tr = Transition(
            obs=put(obs_l), act=put(act_l), obs_next=put(obsn_l),
            reward=put(rew_l, torch.float32),
            cost=put(cost_l, torch.float32)[..., None],
            terminated=put(term_l), truncated=put(trunc_l),
            logp=put(logp_l))
        mean_c = torch.tensor([sum_c / max(n_ep, 1)], dtype=torch.float32,
                              device=dev)
        n_ep_t = torch.tensor(n_ep, dtype=torch.int32, device=dev)
        self.collect_split = {"env": t_env, "act": t_act,
                              "transfer": time.perf_counter() - t0}
        return tr, mean_c, n_ep_t

    # ------------------------------------------------------------------
    def _train_iter(self) -> None:
        tr, mean_c, n_ep = self.collect_segment()
        self.state, self.last_metrics = self.algo.update(
            self.state, tr, mean_c, n_ep, self.generator)

    def __iter__(self):
        return self

    def __next__(self):
        if self.epoch >= self.epochs:
            raise StopIteration
        self.epoch += 1
        steps = 0
        while steps < self.step_per_epoch:
            self._train_iter()
            self._host_params = None   # a fresh inference copy next collect
            steps += self.T * self.venv.n
            self.env_step += self.T * self.venv.n

        stats = self.collector.collect(
            self.act_fn_eval, self._inference_params(),
            self.episode_per_test, self.host_generator)
        rew, cost = stats["rew"], stats["cost"]
        self.logger.store(tab="test", reward=rew, cost=cost,
                          length=stats["len"])
        if perf_is_better(rew, cost, self.best_rew, self.best_cost,
                          self.cost_limit) or not self.has_best:
            self.best_rew, self.best_cost = rew, cost
            self.has_best = True
            if self.logger.log_dir:
                save_checkpoint(osp.join(self.logger.log_dir, "checkpoint",
                                         "model_best.pt"), self.state)
        dur = time.time() - self.start_time
        info = dict(epoch=self.epoch, env_step=self.env_step,
                    best_reward=self.best_rew, best_cost=self.best_cost,
                    test_reward=rew, test_cost=cost,
                    speed=self.env_step / max(dur, 1e-9))
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


class HostOffpolicyTrainer(HostOnpolicyTrainer):
    """Off-policy loop over host envs: each segment goes into the ring
    replay buffer on the device, then ``n_updates = max(1,
    round(update_per_step * T * N))`` grad steps on sampled minibatches
    (reference ``fsrl/trainer/offpolicy.py:93-106``). The buffer holds
    ``max(buffer_size // N, T)`` rows per env."""

    def __init__(self, algo, venv, test_venv=None, logger=None, *,
                 buffer_size: int = 100000, update_per_step: float = 0.2,
                 steps_per_collect: int = 100, **kwargs):
        if not hasattr(algo, "update_step"):
            raise TypeError(
                f"{type(algo).__name__} is an on-policy algorithm (no "
                "update_step): use HostOnpolicyTrainer")
        super().__init__(algo, venv, test_venv, logger,
                         steps_per_collect=steps_per_collect, **kwargs)
        self.buffer = ReplayBuffer(max(buffer_size // venv.n,
                                       steps_per_collect), venv.n,
                                   self.device)
        self.buf_state = self.buffer.init(
            venv.observation_size, venv.action_size, venv.num_costs)
        self.n_updates = max(1, int(round(
            update_per_step * steps_per_collect * venv.n)))

    def update_block(self, mean_c: torch.Tensor, n_ep: torch.Tensor,
                     draws: Optional[list] = None) -> dict:
        """``update_lagrangian``, ``pre_update``, the ``n_updates`` grad
        steps and ``post_update``, where the algorithm has them (the JAX
        package's order); returns the last step's metrics. ``draws``, one
        dict a step, replaces the steps' random draws (the parity tests
        pass JAX's)."""
        algo, state = self.algo, self.state
        if hasattr(algo, "update_lagrangian"):
            state = algo.update_lagrangian(state, mean_c, n_ep)
        if hasattr(algo, "pre_update"):
            state = algo.pre_update(state)
        view = make_nstep_view(self.buffer, self.buf_state)
        metrics: dict = {}
        for i in range(self.n_updates):
            state, metrics = algo.update_step(
                state, self.buffer, self.buf_state, self.generator,
                view=view, draws=None if draws is None else draws[i])
        if hasattr(algo, "post_update"):
            state = algo.post_update(state)
        self.state = state
        return metrics

    def _train_iter(self) -> None:
        tr, mean_c, n_ep = self.collect_segment()
        self.buf_state = self.buffer.add_segment(self.buf_state, tr)
        self.last_metrics = self.update_block(mean_c, n_ep)
