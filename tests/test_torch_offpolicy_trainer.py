"""The port's off-policy trainer and agents on the CPU: a short ``learn`` of
each agent (grad steps per collect, env-step and update counters, the
buffer's cursor, finite metrics, the logged keys against the JAX trainer's
and the JAX algorithm's), checkpoint and ``resume_from`` of every state
field, ``update_chunk`` changing nothing, CVPO's per-collect hooks, and the
three configs' fields and defaults against the JAX package's."""

import dataclasses
import math
import os

import jax
import numpy as np
import pytest
import torch

from fsrl_torch.agent import CVPOAgent, DDPGLagAgent, SACLagAgent
from fsrl_torch.algos.cvpo import CVPO
from fsrl_torch.algos.ddpg_lag import DDPGLag
from fsrl_torch.algos.sac_lag import SACLag
from fsrl_torch.config import configs as tcfg
from fsrl_torch.config.cli import parse_config
from fsrl_torch.trainer import OffpolicyTrainer
from fsrl_torch.utils.checkpoint import to_state_dict
from fsrl_torch.utils.logger import BaseLogger
from fsrl_tpu.algos.cvpo import CVPO as JCVPO
from fsrl_tpu.algos.ddpg_lag import DDPGLag as JDDPGLag
from fsrl_tpu.algos.sac_lag import SACLag as JSACLag
from fsrl_tpu.config import configs as jcfg

torch.set_num_threads(1)

TASK = "SafetyBallCircle-v0"
HIDDEN = (32, 32)
# 4 envs x 100 steps per collect, 0.05 grad steps per env step: 20 per
# collect, two collects
LEARN = dict(epochs=1, step_per_epoch=800, n_envs=4, steps_per_collect=100,
             episode_per_test=1, buffer_size=1000, update_per_step=0.05)
AGENTS = [(DDPGLagAgent, JDDPGLag), (SACLagAgent, JSACLag),
          (CVPOAgent, JCVPO)]
IDS = ["ddpg_lag", "sac_lag", "cvpo"]


def _agent(cls, seed=0, **kw):
    return cls(TASK, cost_limit=10.0, seed=seed, device="cpu",
               hidden_sizes=HIDDEN, batch_size=32, **kw)


@pytest.fixture(scope="module")
def jax_trainer_keys():
    """The keys the JAX package's off-policy trainer logs in one epoch of
    SAC-Lag at this test's shape, minus SAC-Lag's update metrics: the
    trainer's own ``train/``, ``test/`` and ``update/`` keys."""
    from fsrl_tpu.envs import make
    from fsrl_tpu.trainer.trainer import OffpolicyTrainerTPU
    from fsrl_tpu.utils.logger import BaseLogger as JBaseLogger
    env = make(TASK)
    algo = JSACLag(env.observation_size, env.action_size, cost_limit=10.0,
                   hidden_sizes=HIDDEN, batch_size=32)
    logger = JBaseLogger()
    kw = {k: v for k, v in LEARN.items()}
    tr = OffpolicyTrainerTPU(algo, env, logger, cost_limit=10.0, seed=0,
                             verbose=False, **kw)
    tr.run()
    return set(logger.stats) - {f"loss/{k}" for k in (
        "q_total", "actor_total", "actor_rew", "alpha_value", "alpha_loss",
        "rescaling", "lagrangian")}


def _jax_metric_keys(jcls, algo):
    """The metric keys of the JAX algorithm's ``update_step``, from its
    abstract evaluation (nothing is compiled)."""
    from fsrl_tpu.data.buffer import ReplayBuffer as JReplayBuffer
    kw = dict(hidden_sizes=HIDDEN, num_costs=algo.num_costs)
    if jcls is JCVPO:
        kw["max_episode_steps"] = 500
    jalgo = jcls(algo.obs_dim, algo.act_dim, **kw)
    buf = JReplayBuffer(16, 2)
    bs = buf.init(algo.obs_dim, algo.act_dim, algo.num_costs)
    state = jax.eval_shape(jalgo.init, jax.random.PRNGKey(0))
    _, metrics = jax.eval_shape(
        lambda s, b, k: jalgo.update_step(s, buf, b, k), state, bs,
        jax.random.PRNGKey(0))
    return set(metrics)


@pytest.mark.parametrize("agent_cls,jcls", AGENTS, ids=IDS)
def test_learn_counts_steps_and_logs_jax_keys(agent_cls, jcls,
                                              jax_trainer_keys):
    logger = BaseLogger()
    agent = _agent(agent_cls, logger=logger)
    info = agent.learn(**LEARN)
    tr = agent.trainer
    assert isinstance(tr, OffpolicyTrainer)
    assert tr.n_updates == 20
    assert info["env_step"] == tr.env_step == 800
    assert int(agent.state.gradient_steps) == 40
    assert int(agent.state.update_count) == 40
    # the ring: max(1000 // 4, 100) = 250 rows per env, 200 written
    assert (tr.buffer.C, tr.buf_state.pos, tr.buf_state.filled) == (250, 200,
                                                                   200)
    assert tr.last_metrics and all(math.isfinite(v)
                                   for v in tr.last_metrics.values())
    assert all(math.isfinite(info[k]) for k in ("test_reward", "test_cost"))
    assert set(tr.last_metrics) == _jax_metric_keys(jcls, agent.algo)
    logged = set(logger.stats)
    assert {"train/reward", "test/reward", "update/gradient_step"} <= logged
    assert logged == jax_trainer_keys | set(tr.last_metrics)
    if agent_cls is CVPOAgent:
        # post_update ran after the last grad step: old actor == actor
        assert torch.equal(agent.state.actor_old_params.flat,
                           torch.cat([p.detach().reshape(-1) for p in
                                      agent.state.params.actor.parameters()]))
        assert agent.algo._qc_coeff == pytest.approx(
            (1 - 0.98 ** 500) / (1 - 0.98) / 500)


@pytest.mark.parametrize("agent_cls", [a for a, _ in AGENTS], ids=IDS)
def test_checkpoint_and_resume_restore_every_field(agent_cls, tmp_path):
    """``model.pt`` holds every state field by name (targets, old actor,
    duals, optimizer states); ``resume_from`` restores it into a trainer
    whose own init differs, bit for bit, and training goes on."""
    logger = BaseLogger(str(tmp_path))
    agent = _agent(agent_cls, logger=logger)
    agent.learn(save_model_interval=1, **LEARN)
    ck = os.path.join(str(tmp_path), "checkpoint", "model.pt")
    assert os.path.isfile(ck)
    saved = to_state_dict(agent.state)
    fields = {f.name for f in dataclasses.fields(agent.state)}
    assert set(saved) == fields
    kw = {k: v for k, v in LEARN.items()}
    t2 = OffpolicyTrainer(agent.algo, agent.env, BaseLogger(), seed=7,
                          cost_limit=10.0, verbose=False, resume_from=ck,
                          **kw)

    def leaves(tree, prefix=""):
        if isinstance(tree, torch.Tensor):
            yield prefix, tree
        else:
            for k, v in tree.items():
                yield from leaves(v, f"{prefix}.{k}")

    got = dict(leaves(to_state_dict(t2.state)))
    want = dict(leaves(saved))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # the flat vectors hold the restored parameters
    assert torch.equal(t2.state.params.flat, agent.state.params.flat)
    before = int(t2.state.update_count)
    t2._run_iter()
    assert int(t2.state.update_count) == before + t2.n_updates


def test_update_chunk_changes_nothing():
    """``update_chunk`` groups dispatches in JAX; here two values give the
    same training bit for bit."""
    states = []
    for chunk in (1, 32):
        agent = _agent(SACLagAgent)
        agent.learn(update_chunk=chunk, **LEARN)
        states.append(agent.state)
    assert torch.equal(states[0].params.flat, states[1].params.flat)
    assert torch.equal(states[0].target_critic_params.flat,
                       states[1].target_critic_params.flat)


OFFPOLICY_CFGS = [("DDPGLagCfg", DDPGLag), ("SACLagCfg", SACLag),
                  ("CVPOCfg", CVPO)]


@pytest.mark.parametrize("name,algo_cls", OFFPOLICY_CFGS,
                         ids=[n for n, _ in OFFPOLICY_CFGS])
def test_offpolicy_configs_match_jax(name, algo_cls):
    """Fields and defaults equal the JAX package's (the mesh switch
    included), apart from the port's own ``device`` field and logger
    names; the config builds its algorithm; flags parse."""
    tc, jc = getattr(tcfg, name)(), getattr(jcfg, name)()
    skip = {"device", "project", "prefix"}
    want = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)
            if f.name not in skip}
    got = {f.name: getattr(tc, f.name) for f in dataclasses.fields(tc)
           if f.name not in skip}
    assert got == want
    assert tc.algo_kwargs() == jc.algo_kwargs()
    algo = algo_cls(8, 2, cost_limit=tc.cost_limit, device="cpu",
                    **tc.algo_kwargs())
    assert algo.hp["batch_size"] == tc.batch_size
    cfg = parse_config(getattr(tcfg, name), ["--buffer_size", "5000",
                                             "--update_per_step", "0.5",
                                             "--hidden_sizes", "64,64"])
    assert (cfg.buffer_size, cfg.update_per_step, cfg.hidden_sizes) == (
        5000, 0.5, (64, 64))


@pytest.mark.parametrize("agent_cls", [a for a, _ in AGENTS], ids=IDS)
def test_offpolicy_agent_without_cuda_raises(agent_cls):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        agent_cls(TASK)


def test_evaluate_returns_the_reference_triple():
    agent = _agent(DDPGLagAgent)
    rew, length, cost = agent.evaluate(n_episodes=2)
    assert length == 500.0 and np.isfinite(rew) and cost >= 0.0
