"""Host (Gymnasium-API) environments behind the port's cost-aware API
(port of ``fsrl_tpu/envs/host_env.py``).

``HostVectorEnv`` steps any env that reports its safety signal in
``info["cost"]`` (Safety-Gymnasium's velocity tasks, a raw-MuJoCo
navigation task, a numpy stand-in) on a thread pool: MuJoCo's step releases
the GIL. ``HostCollector`` collects exactly ``n_episode`` episodes, masking
the surplus envs so that the statistics are not biased towards short
episodes (the reference's ``FastCollector``).

Nothing here imports gymnasium: the envs come from the caller's factories.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence

import numpy as np
import torch


class HostVectorEnv:
    """``n`` host envs stepped on a thread pool; observations are float32
    rows, costs come from ``info["cost"]`` (missing: 0)."""

    def __init__(self, env_fns: Sequence[Callable], num_threads: int = 8):
        self.envs = [fn() for fn in env_fns]
        self.n = len(self.envs)
        self.pool = ThreadPoolExecutor(max_workers=min(num_threads, self.n))
        space = self.envs[0].observation_space
        self.observation_size = int(np.prod(space.shape))
        aspace = self.envs[0].action_space
        self.discrete = not hasattr(aspace, "low")
        self.action_size = int(np.prod(aspace.shape)) if aspace.shape else 1
        self.action_low = np.asarray(getattr(aspace, "low", 0.0))
        self.action_high = np.asarray(
            getattr(aspace, "high", getattr(aspace, "n", 2) - 1))
        spec = getattr(self.envs[0], "spec", None)
        self.max_episode_steps = getattr(spec, "max_episode_steps",
                                         None) or 1000
        self.num_costs = 1

    def reset(self, seed: Optional[int] = None,
              ids: Optional[Sequence[int]] = None) -> np.ndarray:
        """Reset the envs ``ids`` (all by default); env ``i`` is seeded
        ``seed + i`` when ``seed`` is given."""
        ids = range(self.n) if ids is None else ids

        def _reset(i):
            kw = {"seed": seed + i} if seed is not None else {}
            obs, _ = self.envs[i].reset(**kw)
            return np.asarray(obs, np.float32).ravel()

        return np.stack(list(self.pool.map(_reset, ids)))

    def step(self, actions: np.ndarray, ids: Optional[Sequence[int]] = None):
        """``(obs, reward, cost, terminated, truncated)`` over ``ids``. An
        env with the old 4-tuple API has its truncation read from
        ``info["TimeLimit.truncated"]``."""
        ids = list(range(self.n)) if ids is None else list(ids)
        if self.discrete:
            actions = np.round(np.asarray(actions)).astype(np.int64).ravel()

        def _step(k):
            out = self.envs[ids[k]].step(actions[k])
            if len(out) == 5:
                obs, rew, term, trunc, info = out
            else:
                obs, rew, done, info = out
                trunc = bool(info.get("TimeLimit.truncated", False))
                term = bool(done) and not trunc
            cost = float(info.get("cost", 0.0))
            return (np.asarray(obs, np.float32).ravel(), float(rew), cost,
                    bool(term), bool(trunc))

        res = list(self.pool.map(_step, range(len(ids))))
        obs, rew, cost, term, trunc = map(np.array, zip(*res))
        return obs.astype(np.float32), rew, cost, term, trunc

    def scale_action(self, act: np.ndarray) -> np.ndarray:
        """A policy action in [-1, 1] (clipped) mapped onto the env's
        bounds."""
        return self.action_low + (self.action_high - self.action_low) * \
            (np.clip(act, -1.0, 1.0) + 1.0) / 2.0

    def close(self):
        for e in self.envs:
            e.close()
        self.pool.shutdown()


def host_actions(act_fn, params, obs: np.ndarray, generator: torch.Generator
                 ) -> tuple[np.ndarray, np.ndarray]:
    """``act_fn(params, obs, generator)`` on a batch of host observations:
    the actions and log-probs as numpy arrays."""
    with torch.no_grad():
        act, logp = act_fn(params, torch.from_numpy(
            np.asarray(obs, np.float32)), generator)
    return act.float().cpu().numpy(), logp.float().cpu().numpy()


class HostCollector:
    """Episode-exact collection from host envs with a policy ``act_fn(params,
    obs, generator) -> (actions, logp)`` whose actions in [-1, 1] are mapped
    onto the env's bounds."""

    def __init__(self, venv: HostVectorEnv):
        self.venv = venv

    def collect(self, act_fn, params, n_episode: int,
                generator: torch.Generator,
                max_steps: Optional[int] = None) -> dict:
        venv = self.venv
        N = venv.n
        obs = venv.reset()
        alive = np.ones(N, bool)
        remaining = n_episode
        ep_r, ep_c, ep_len = np.zeros(N), np.zeros(N), np.zeros(N, int)
        R, C, L, n_term, n_trunc = [], [], [], 0, 0
        max_steps = max_steps or (venv.max_episode_steps
                                  * (n_episode // N + 2))
        for _ in range(max_steps):
            if remaining <= 0:
                break
            act, _ = host_actions(act_fn, params, obs, generator)
            obs_n, rew, cost, term, trunc = venv.step(venv.scale_action(act))
            ep_r += rew * alive
            ep_c += cost * alive
            ep_len += alive.astype(int)
            done = (term | trunc) & alive
            for i in np.nonzero(done)[0]:
                if remaining > 0:
                    R.append(ep_r[i])
                    C.append(ep_c[i])
                    L.append(ep_len[i])
                    n_term += int(term[i])
                    n_trunc += int(trunc[i])
                    remaining -= 1
                ep_r[i] = ep_c[i] = 0.0
                ep_len[i] = 0
                obs_n[i] = venv.reset(ids=[i])[0]
                if remaining < int(alive.sum()):
                    # surplus-env masking: no more envs counting than
                    # episodes still needed
                    alive[i] = False
            obs = obs_n
        return {
            "n/ep": len(R), "n/st": int(np.sum(L)),
            "rew": float(np.mean(R)) if R else 0.0,
            "cost": float(np.mean(C)) if C else 0.0,
            "len": float(np.mean(L)) if L else 0.0,
            "terminated": n_term, "truncated": n_trunc,
        }
