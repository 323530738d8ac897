"""Agent layer (port of ``BaseAgentTPU`` and the five on-policy and three
off-policy agents of ``fsrl_tpu/agent/agents.py``): the algorithm
with its default recipe, the trainer that fits it (on-policy or
off-policy), ``stop_fn = reward > threshold and cost < limit``, and an
episode-exact ``evaluate``.

Agents run on CUDA unless ``device="cpu"`` is passed; without CUDA they
raise.
"""

from __future__ import annotations

import inspect
from typing import Optional, Union

import numpy as np
import torch

from fsrl_torch.algos.cpo import CPO
from fsrl_torch.algos.cvpo import CVPO
from fsrl_torch.algos.ddpg_lag import DDPGLag
from fsrl_torch.algos.focops import FOCOPS
from fsrl_torch.algos.ppo_lag import PPOLag
from fsrl_torch.algos.ppo_lag_rnn import RecurrentPPOLag
from fsrl_torch.algos.sac_lag import SACLag
from fsrl_torch.algos.trpo_lag import TRPOLag
from fsrl_torch.data.collector import evaluate
from fsrl_torch.device import resolve_device
from fsrl_torch.envs.base import SafeEnv, make
from fsrl_torch.trainer.trainer import OffpolicyTrainer, OnpolicyTrainer
from fsrl_torch.utils.logger import BaseLogger, DummyLogger


class BaseAgent:
    """Policy factory plus ``learn`` / ``evaluate``."""

    name = "BaseAgent"
    algo_cls = None
    onpolicy = True
    # CPO and FOCOPS take one constraint
    multi_constraint = True

    def __init__(self, env: Union[str, SafeEnv],
                 logger: Optional[BaseLogger] = None,
                 cost_limit: float = 10.0, seed: int = 10, device=None,
                 **algo_kwargs):
        self.device = resolve_device(device)
        self.env = make(env) if isinstance(env, str) else env
        self.logger = logger or DummyLogger()
        self.cost_limit = cost_limit
        self.seed = seed
        self.algo = self._build_algo(cost_limit, **algo_kwargs)
        self.state = self.algo.init(seed)
        self.trainer = None

    def _build_algo(self, cost_limit, **kw):
        if self.multi_constraint:
            kw.setdefault("num_costs", self.env.num_costs)
        if "episode_len" in inspect.signature(self.algo_cls.__init__).parameters:
            # one (T+1)-row critic pass in process_rollout, with the
            # truncation rows bounded by the env's horizon
            kw.setdefault("episode_len", self.env.max_episode_steps)
        return self.algo_cls(self.env.observation_size, self.env.action_size,
                             cost_limit=cost_limit, device=self.device, **kw)

    def learn(self, epochs: int = 100, step_per_epoch: int = 10000,
              n_envs: int = 20, steps_per_collect: int = 125,
              episode_per_test: int = 10, save_model_interval: int = 4,
              reward_threshold: Optional[float] = None,
              buffer_size: int = 100000, update_per_step: float = 0.2,
              verbose: bool = False, **trainer_kwargs) -> dict:
        """Train with the trainer that fits the algorithm; ``buffer_size``
        and ``update_per_step`` are the off-policy trainer's."""
        stop_fn = None
        if reward_threshold is not None:
            limit = float(np.sum(self.cost_limit))
            stop_fn = lambda rew, cost: rew > reward_threshold and cost < limit
        common = dict(
            epochs=epochs, step_per_epoch=step_per_epoch, n_envs=n_envs,
            steps_per_collect=steps_per_collect,
            episode_per_test=episode_per_test, cost_limit=self.cost_limit,
            save_model_interval=save_model_interval, stop_fn=stop_fn,
            seed=self.seed, verbose=verbose, state=self.state,
            **trainer_kwargs)
        if self.onpolicy:
            self.trainer = OnpolicyTrainer(self.algo, self.env, self.logger,
                                           **common)
        else:
            self.trainer = OffpolicyTrainer(
                self.algo, self.env, self.logger, buffer_size=buffer_size,
                update_per_step=update_per_step, **common)
        info = self.trainer.run()
        self.state = self.trainer.state
        return info

    def evaluate(self, n_episodes: int = 10, state=None, seed: int = 0
                 ) -> tuple[float, float, float]:
        """(mean reward, mean length, mean cost) over ``n_episodes``
        episodes."""
        st = state if state is not None else self.state
        g = torch.Generator(device=self.device).manual_seed(seed)
        out = evaluate(self.env, self.algo.act_fn_eval, st.params, g,
                       n_episodes,
                       init_hidden=getattr(self.algo, "init_hidden", None))
        return (float(out["reward"]), float(out["length"]),
                float(out["cost"]))


class PPOLagAgent(BaseAgent):
    """Defaults: hidden (128, 128), joint Adam lr 5e-4, PID
    (0.05, 0.0005, 0.1)."""

    name = "PPOLagAgent"
    algo_cls = PPOLag


class RecurrentPPOLagAgent(BaseAgent):
    """GRU-actor PPO-Lagrangian trained with truncated BPTT. Defaults: GRU
    128, critics (128, 128), joint Adam lr 5e-4, PID (0.05, 0.0005, 0.1)."""

    name = "RecurrentPPOLagAgent"
    algo_cls = RecurrentPPOLag


class TRPOLagAgent(BaseAgent):
    """Defaults: target_kl 0.001, 20 critic iterations, whole-batch natural
    gradient."""

    name = "TRPOLagAgent"
    algo_cls = TRPOLag


class CPOAgent(BaseAgent):
    """Defaults: target_kl 0.01, critic lr 1e-3, 10 critic iterations."""

    name = "CPOAgent"
    algo_cls = CPO
    multi_constraint = False


class FOCOPSAgent(BaseAgent):
    """Defaults: auto-nu (nu_max 2.0, nu_lr 1e-2, nu_init 0.01)."""

    name = "FOCOPSAgent"
    algo_cls = FOCOPS
    multi_constraint = False


class DDPGLagAgent(BaseAgent):
    """Defaults: n_step 3, tau 0.005, exploration noise 0.1, PID
    (0.5, 0.001, 0.1)."""

    name = "DDPGLagAgent"
    algo_cls = DDPGLag
    onpolicy = False


class SACLagAgent(BaseAgent):
    """Defaults: double critics, auto-alpha, conditioned sigma, stochastic
    evaluation."""

    name = "SACLagAgent"
    algo_cls = SACLag
    onpolicy = False


class CVPOAgent(BaseAgent):
    """Defaults: gamma 0.98, 16 particles, E- and M-step duals; the qc
    threshold takes the env's ``max_episode_steps``."""

    name = "CVPOAgent"
    algo_cls = CVPO
    onpolicy = False

    def _build_algo(self, cost_limit, **kw):
        kw.setdefault("max_episode_steps", self.env.max_episode_steps)
        return super()._build_algo(cost_limit, **kw)
