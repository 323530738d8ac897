"""The data-parallel cases of ``tests/test_torch_parallel.py``, run the same
way by the test process (one process, no mesh) and by each rank of
``tests/_torch_dp_worker.py`` (a mesh of gloo ranks on the CPU). Imports
only ``torch``, ``numpy`` and ``fsrl_torch``. Every case returns a flat
dict of numpy arrays; a rank returns its own envs' part of any per-env
array."""

import numpy as np
import torch

from fsrl_torch.algos.common import process_rollout
from fsrl_torch.algos.cpo import CPO
from fsrl_torch.algos.focops import FOCOPS
from fsrl_torch.algos.ppo_lag import PPOLag
from fsrl_torch.algos.ppo_lag_rnn import RecurrentPPOLag
from fsrl_torch.algos.sac_lag import SACLag
from fsrl_torch.algos.trpo_lag import TRPOLag
from fsrl_torch.data.collector import make_rollout_fn
from fsrl_torch.envs import make
from fsrl_torch.parallel.mesh import DPGroup, EnvRows, shard_env_state
from fsrl_torch.trainer.trainer import OffpolicyTrainer, OnpolicyTrainer
from fsrl_torch.types import EpisodeStats

N, T = 8, 16
MB = dict(repeat=2, n_minibatches=2)
# case -> (task, algorithm, its keywords): one train step each (a collect
# of T steps of N envs and one update), as tests/test_parallel.py's
ONPOLICY = {
    "ppo_lag_dp_blocks_1": ("SafetyBallRun-v0", PPOLag, dict(MB)),
    "ppo_lag_dp_blocks_2": ("SafetyBallRun-v0", PPOLag,
                            dict(MB, dp_blocks=2)),
    # a negative KL target stops the update at the first epoch's end
    "ppo_lag_early_stop": ("SafetyBallRun-v0", PPOLag,
                           dict(MB, target_kl=-1.0)),
    "ppo_lag_rew_norm": ("SafetyBallRun-v0", PPOLag,
                         dict(MB, dp_blocks=2, reward_normalization=True)),
    # the one-pass critic with episodes of 6 steps: every env truncates
    # twice in the segment, at the same steps on both ranks, and the
    # truncated rows' values come from one gather over both ranks' envs
    "ppo_lag_one_pass": ("SafetyBallRun-v0", PPOLag,
                         dict(MB, dp_blocks=2, episode_len=6)),
    # an env that draws in its steps (a goal resampled on reach)
    "ppo_lag_nav": ("SafetyPointGoal1-v0", PPOLag, dict(MB, dp_blocks=2)),
    "focops_dp_blocks_2": ("SafetyBallRun-v0", FOCOPS,
                           dict(MB, dp_blocks=2)),
    "trpo_lag": ("SafetyBallRun-v0", TRPOLag, dict()),
    "cpo": ("SafetyBallRun-v0", CPO, dict()),
    "ppo_lag_rnn": ("SafetyBallRun-v0", RecurrentPPOLag, dict(MB)),
}


def _algo(cls, env, **kw):
    return cls(env.observation_size, env.action_size, cost_limit=10.0,
               device="cpu", **kw)


def onpolicy_step(case: str, weights: dict, mesh=None) -> dict:
    """One train step from ``weights`` (a state dict of numpy arrays):
    returns the flat parameters, the metrics, the gradient steps and the
    rank's transitions."""
    task, cls, kw = ONPOLICY[case]
    env = make(task)
    if "episode_len" in kw:
        env.max_episode_steps = kw["episode_len"]
    algo = _algo(cls, env, **kw)
    state = algo.init(state_dict={k: torch.from_numpy(v)
                                  for k, v in weights.items()})
    g = torch.Generator().manual_seed(1)
    env_state = env.reset_vec(N, g)
    draw, dp, lo, hi = g, None, 0, N
    if mesh is not None:
        dp = DPGroup.of(mesh)
        lo, hi = dp.block(N)
        env_state = shard_env_state(mesh, env_state)
        draw = EnvRows(g, N, lo, hi)
    init_hidden = getattr(algo, "init_hidden", None)
    rollout = make_rollout_fn(env, algo.act_fn, T, "cpu",
                              init_hidden=init_hidden)
    res = rollout(state.params, env_state,
                  EpisodeStats.init(hi - lo, env.num_costs), draw)
    stats = res.stats if dp is None else res.stats.merge_across(dp)
    extra = {} if dp is None else dict(dp=dp)
    head = ((res.transitions, res.init_hidden) if init_hidden
            else (res.transitions,))
    batch = {}
    if "episode_len" in kw:
        # the advantages the update takes (the rank's env-major rows)
        batch = process_rollout(state.params.critics, res.transitions, 0.99,
                                0.95, episode_len=kw["episode_len"], dp=dp)
        batch = {"adv": batch.adv.numpy(), "ret": batch.ret.numpy()}
    state, metrics = algo.update(state, *head, stats.mean_cost,
                                 stats.n_episodes, g, **extra)
    out = {f"metric/{k}": v.numpy() for k, v in metrics.items()}
    out.update(flat=state.flat.numpy(),
               gradient_steps=state.gradient_steps.numpy(),
               n_episodes=stats.n_episodes.numpy(),
               **{f"tr/{k}": v.numpy()
                  for k, v in vars(res.transitions).items()},
               **{f"batch/{k}": v for k, v in batch.items()})
    if cls is TRPOLag:
        out["backtracks"] = algo.last_backtracks.numpy()
    return out


def init_weights(case: str) -> dict:
    """The port's initial weights of a case (numpy), for the cases whose
    JAX algorithm the test process does not bridge."""
    task, cls, kw = ONPOLICY[case]
    model = _algo(cls, make(task), **kw).init(seed=0).params
    return {k: v.detach().numpy().copy()
            for k, v in model.state_dict().items()}


def episode_stats(mesh=None) -> dict:
    """Every env truncates once in ``max_episode_steps + 2`` steps: the
    merged count of finished episodes is N."""
    env = make("SafetyBallRun-v0")
    g = torch.Generator().manual_seed(0)
    state = env.reset_vec(N, g)
    draw, dp, n = g, None, N
    if mesh is not None:
        dp = DPGroup.of(mesh)
        lo, hi = dp.block(N)
        state, draw, n = (shard_env_state(mesh, state),
                          EnvRows(g, N, lo, hi), hi - lo)
    act = lambda p, o, gen: (torch.zeros(o.shape[:-1] + (env.action_size,)),
                             torch.zeros(o.shape[:-1]))
    res = make_rollout_fn(env, act, env.max_episode_steps + 2, "cpu")(
        None, state, EpisodeStats.init(n, 1), draw)
    stats = res.stats if dp is None else res.stats.merge_across(dp)
    return dict(n_episodes=stats.n_episodes.numpy(),
                local_episodes=res.stats.n_episodes.numpy(),
                n_steps=stats.n_steps.numpy())


def sac_lag_trainer(mesh=None) -> dict:
    """SAC-Lag through the off-policy trainer, 3 iterations (the JAX
    test's shape): the parameters and the rank's buffer columns."""
    env = make("SafetyBallRun-v0")
    algo = _algo(SACLag, env, batch_size=32, n_step=2)
    tr = OffpolicyTrainer(
        algo, env, None, cost_limit=10.0, seed=0, n_envs=N,
        steps_per_collect=12, update_per_step=0.1, buffer_size=2048,
        epochs=1, step_per_epoch=10**9, verbose=False, log_every=10**9,
        mesh=mesh)
    for _ in range(3):
        tr._run_iter()
    out = {f"buf/{k}": v.numpy() for k, v in vars(tr.buf_state.data).items()}
    out.update(flat=tr.state.params.flat.numpy(),
               target=tr.state.target_critic_params.flat.numpy(),
               log_alpha=tr.state.log_alpha.numpy(),
               multiplier=tr.state.lag.multiplier.numpy())
    return out


def ppo_trainer(mesh=None) -> dict:
    """PPO-Lag through the on-policy trainer: one epoch of two iterations
    and the episode-exact test (on rank 0 under a mesh)."""
    env = make("SafetyBallRun-v0")
    algo = _algo(PPOLag, env, **MB)
    tr = OnpolicyTrainer(algo, env, None, cost_limit=10.0, seed=0,
                         n_envs=N, steps_per_collect=T, epochs=1,
                         step_per_epoch=2 * N * T, episode_per_test=2,
                         verbose=False, mesh=mesh)
    info = tr.run()
    return dict(flat=tr.state.flat.numpy(),
                test_reward=np.float64(info["test_reward"]),
                env_step=np.int64(info["env_step"]),
                generator=tr.generator.get_state().numpy())


def run_all(weights: dict, mesh=None) -> dict:
    """Every case, results under ``<case>/<key>``."""
    out = {}
    for case in ONPOLICY:
        w = {k[len(case) + 1:]: v for k, v in weights.items()
             if k.startswith(case + "/")}
        out.update({f"{case}/{k}": v
                    for k, v in onpolicy_step(case, w, mesh).items()})
    for name, fn in (("stats", episode_stats), ("sac_lag", sac_lag_trainer),
                     ("trainer", ppo_trainer)):
        out.update({f"{name}/{k}": v for k, v in fn(mesh).items()})
    return out
