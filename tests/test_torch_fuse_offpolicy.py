"""The port's off-policy ``fuse_iters`` and ``update_chunk`` on the CPU, the
twin of ``tests/test_fuse_offpolicy.py``: k collect-and-update cycles a
dispatch match k sequential dispatches (the same generator stream, buffer
contents and PID steps, the same parameters, bit for bit), ``update_chunk``
changes no result, and the grad steps fall into JAX's ``chunk_sizes``. On
the card each chunk (or the k cycles) replays a CUDA graph
(``chip_smoke.py``'s ``[graph ...]`` phases); here they run eagerly."""

import pytest
import torch

from fsrl_torch.agent import SACLagAgent
from fsrl_torch.trainer import OffpolicyTrainer
from fsrl_torch.utils.checkpoint import to_state_dict
from fsrl_tpu.algos.sac_lag import SACLag as JSACLag
from fsrl_tpu.envs import make as jmake
from fsrl_tpu.trainer.trainer import OffpolicyTrainerTPU

torch.set_num_threads(1)


def build(fuse=1, chunk=8):
    """``tests/test_fuse_offpolicy.py``'s configuration: SAC-Lag on
    BallRun, batch 32, 4 envs x 16 steps, 0.25 grad steps an env step,
    buffer 4096, one epoch of 256 steps."""
    agent = SACLagAgent("SafetyBallRun-v0", cost_limit=10.0, batch_size=32,
                        seed=0, device="cpu")
    return OffpolicyTrainer(
        agent.algo, agent.env, None, cost_limit=10.0, seed=0, n_envs=4,
        steps_per_collect=16, epochs=1, step_per_epoch=256,
        episode_per_test=2, verbose=False, log_every=10 ** 9,
        update_per_step=0.25, update_chunk=chunk, buffer_size=4096,
        fuse_iters=fuse, state=agent.state)


def _tensors(tree, prefix=""):
    return {k: v for k, v in _flat(to_state_dict(tree), prefix)}


def _flat(d, prefix):
    if isinstance(d, dict):
        for k, v in d.items():
            yield from _flat(v, f"{prefix}.{k}")
    else:
        yield prefix, d


def _assert_equal(a, b):
    sa, sb = _tensors(a.state), _tensors(b.state)
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    for name in vars(a.buf_state.data):
        assert torch.equal(getattr(a.buf_state.data, name),
                           getattr(b.buf_state.data, name)), name
    assert int(a.buf_state.pos) == int(b.buf_state.pos)
    assert a.buf_state.filled == b.buf_state.filled


def test_fused_matches_sequential():
    t1, t2 = build(1), build(4)
    # one epoch = 256 steps = 4 sequential dispatches == 1 fused one
    next(iter(t1))
    next(iter(t2))
    assert t1.env_step == t2.env_step == 256
    assert t1.n_updates == 16 and t1.chunk_sizes == [8, 8]
    _assert_equal(t1, t2)
    assert int(t2.state.gradient_steps) == 4 * 16
    assert (t1._iter_count, t2._iter_count) == (4, 1)
    assert torch.equal(t1.generator.get_state(), t2.generator.get_state())
    assert t2.dispatch_mode == "eager (on the CPU)"
    assert t2.graph is None and not t1.chunk_graphs


@pytest.mark.parametrize("chunk", [8, 256])
def test_update_chunk_changes_nothing(chunk):
    """The port draws from one generator in sequence, so unlike JAX (a key
    split a chunk) the chunk size changes no result."""
    t1, tc = build(chunk=1), build(chunk=chunk)
    for tr in (t1, tc):
        for _ in range(2):
            tr._run_iter()
    _assert_equal(t1, tc)


def _jax_chunks(n_envs, T, ups, chunk):
    env = jmake("SafetyBallRun-v0")
    algo = JSACLag(env.observation_size, env.action_size, cost_limit=10.0,
                   batch_size=32)
    tr = OffpolicyTrainerTPU(algo, env, None, n_envs=n_envs,
                             steps_per_collect=T, update_per_step=ups,
                             update_chunk=chunk, buffer_size=4096,
                             verbose=False)
    return tr.n_updates, tr.chunk_sizes


@pytest.mark.parametrize("n_envs,T,ups,chunk", [
    (32, 100, 0.2, 256),     # 640 grad steps: 256, 256 and a remainder
    (4, 16, 0.25, 8),
    (5, 10, 0.2, 3),
    (5, 10, 0.2, 64),
    (5, 10, 0.2, 0)])
def test_chunk_sizes_are_jax(n_envs, T, ups, chunk):
    agent = SACLagAgent("SafetyBallRun-v0", cost_limit=10.0, batch_size=32,
                        seed=0, device="cpu")
    tr = OffpolicyTrainer(agent.algo, agent.env, None, n_envs=n_envs,
                          steps_per_collect=T, update_per_step=ups,
                          update_chunk=chunk, buffer_size=4096,
                          verbose=False, state=agent.state)
    assert (tr.n_updates, tr.chunk_sizes) == _jax_chunks(n_envs, T, ups,
                                                         chunk)
    assert sum(tr.chunk_sizes) == tr.n_updates
