"""The port's ring replay buffer against the JAX package's: the cases of
``tests/test_buffer.py`` (segment writes, wrap-around, successor linkage,
the newest row's stall and end flag, metric channels) and the
logical-to-physical row map of the sampler, with the same draws. Every
comparison is exact: the buffer moves data and integer indices only."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import n, t

from fsrl_torch.data.buffer import ReplayBuffer
from fsrl_torch.types import Transition
from fsrl_tpu.data.buffer import ReplayBuffer as JReplayBuffer
from fsrl_tpu.types import Transition as JTransition


def make_segment(t0, T, N, obs_dim=3, act_dim=2, seed=None):
    """The JAX tests' segment (obs encodes (t, env), an episode end every
    5 steps), or with ``seed`` random values and random ends."""
    tt = np.arange(t0, t0 + T)[:, None]
    nn_ = np.arange(N)[None, :]
    base = (tt * 100 + nn_).astype(np.float32)
    obs = np.stack([base] * obs_dim, -1)
    term = np.zeros((T, N), bool)
    trunc = np.broadcast_to(tt % 5 == 4, (T, N)).copy()
    act = np.zeros((T, N, act_dim), np.float32)
    if seed is not None:
        rng = np.random.default_rng(seed)
        obs = rng.normal(size=obs.shape).astype(np.float32)
        act = rng.normal(size=act.shape).astype(np.float32)
        term = rng.random((T, N)) < 0.1
        trunc = (rng.random((T, N)) < 0.1) & ~term
    return JTransition(
        obs=jnp.asarray(obs), act=jnp.asarray(act),
        obs_next=jnp.asarray(obs + 0.5), reward=jnp.asarray(base),
        cost=jnp.asarray(base[..., None] * 0.1),
        terminated=jnp.asarray(term), truncated=jnp.asarray(trunc),
        logp=jnp.zeros((T, N)))


def _port(jt):
    return Transition(**{f.name: t(getattr(jt, f.name))
                         for f in dataclasses.fields(jt)})


def _both(C, N, segments):
    """The same segments written into both buffers."""
    jbuf, tbuf = JReplayBuffer(C, N), ReplayBuffer(C, N, device="cpu")
    js, ts = jbuf.init(3, 2), tbuf.init(3, 2)
    for seg in segments:
        js = jbuf.add_segment(js, seg)
        ts = tbuf.add_segment(ts, _port(seg))
    return jbuf, js, tbuf, ts


def _assert_same_data(js, ts):
    for f in dataclasses.fields(JTransition):
        np.testing.assert_array_equal(n(getattr(ts.data, f.name)),
                                      np.asarray(getattr(js.data, f.name)),
                                      err_msg=f.name)
    assert (ts.pos, ts.filled) == (int(js.pos), int(js.filled))


def test_add_and_gather_roundtrip():
    jbuf, js, tbuf, ts = _both(16, 3, [make_segment(0, 8, 3)])
    assert ts.filled == 8 and ts.pos == 8
    _assert_same_data(js, ts)
    got = tbuf.gather(ts, torch.tensor([0 * 3 + 1, 5 * 3 + 2]))
    assert float(got["reward"][0]) == 1.0     # t=0, env=1
    assert float(got["reward"][1]) == 502.0   # t=5, env=2
    assert set(got) == {f.name for f in dataclasses.fields(Transition)}
    assert set(tbuf.gather(ts, torch.tensor([0]), ("obs", "act"))) == {
        "obs", "act"}


@pytest.mark.parametrize("segments", [
    [(0, 8), (8, 4)],            # the JAX test: rows 0-3 overwritten
    [(0, 5), (5, 5), (10, 5)],   # a segment split across the ring's end
    [(0, 8), (8, 8), (16, 3)],   # exactly one lap, then more
], ids=["overwrite", "split_write", "full_lap"])
def test_wraparound_matches_jax(segments):
    segs = [make_segment(t0, T, 2, seed=t0) for t0, T in segments]
    jbuf, js, tbuf, ts = _both(8, 2, segs)
    _assert_same_data(js, ts)
    np.testing.assert_array_equal(n(tbuf.next_flat(ts)),
                                  np.asarray(jbuf.next_flat(js)))
    np.testing.assert_array_equal(n(tbuf.end_flag_flat(ts)),
                                  np.asarray(jbuf.end_flag_flat(js)))
    np.testing.assert_array_equal(n(tbuf.metrics_flat(ts)),
                                  np.asarray(jbuf.metrics_flat(js)))
    # the end flag forces the newest row without writing into the buffer
    _assert_same_data(js, ts)


def test_wraparound_overwrites_oldest():
    jbuf, js, tbuf, ts = _both(8, 2, [make_segment(0, 8, 2),
                                      make_segment(8, 4, 2)])
    assert ts.filled == 8 and ts.pos == 4
    assert float(tbuf.gather(ts, torch.tensor([0]))["reward"][0]) == 800.0
    idx, own = tbuf.sample_indices(ts, 256,
                                   torch.Generator().manual_seed(0))
    assert bool(own.all())                  # one buffer holds every env
    got_t = n(tbuf.gather(ts, idx)["reward"]) // 100
    assert set(got_t.astype(int)) <= set(range(4, 12))   # live rows only


@pytest.mark.parametrize("segments", [[(0, 6)], [(0, 8), (8, 4)]],
                         ids=["partial", "wrapped"])
def test_sample_indices_match_jax_with_its_draws(segments):
    """JAX's ``sample_indices`` draws rows from ``rng`` and envs from
    ``fold_in(rng, 1)``; fed those draws, the port maps them to the same
    flat indices (before and after the ring is full)."""
    jbuf, js, tbuf, ts = _both(8, 3, [make_segment(t0, T, 3)
                                      for t0, T in segments])
    B = 64
    for seed in range(3):
        rng = jax.random.PRNGKey(seed)
        rows = jax.random.randint(rng, (B,), 0, js.filled)
        envs = jax.random.randint(jax.random.fold_in(rng, 1), (B,), 0, 3)
        want = np.asarray(jbuf.sample_indices(js, rng, B))
        got, own = tbuf.sample_indices(ts, B, rows=t(rows).long(),
                                       envs=t(envs).long())
        assert bool(own.all())
        np.testing.assert_array_equal(n(got), want)
        jb = jbuf.gather(js, jnp.asarray(want))
        tb = tbuf.gather(ts, got)
        for k in ("obs", "act", "obs_next", "reward", "terminated"):
            np.testing.assert_array_equal(n(tb[k]), np.asarray(
                getattr(jb, k)), err_msg=k)


def test_generator_draws_cover_valid_rows_and_envs():
    _, _, tbuf, ts = _both(8, 3, [make_segment(0, 5, 3)])
    idx, _ = tbuf.sample_indices(ts, 4096,
                                 torch.Generator().manual_seed(1))
    assert idx.dtype == torch.int64
    assert set(n(idx // 3).tolist()) == set(range(5))
    assert set(n(idx % 3).tolist()) == {0, 1, 2}


def test_next_flat_stalls_at_episode_end_and_newest():
    jbuf, js, tbuf, ts = _both(8, 2, [make_segment(0, 6, 2)])
    nxt = n(tbuf.next_flat(ts)).reshape(8, 2)
    np.testing.assert_array_equal(nxt.reshape(-1),
                                  np.asarray(jbuf.next_flat(js)))
    assert nxt[0, 0] == 1 * 2 + 0      # a normal row advances
    assert nxt[4, 0] == 4 * 2 + 0      # episode end (t % 5 == 4) stalls
    assert nxt[5, 1] == 5 * 2 + 1      # the newest row stalls


def test_end_flag_includes_unfinished_newest():
    jbuf, js, tbuf, ts = _both(8, 2, [make_segment(0, 6, 2)])
    flags = n(tbuf.end_flag_flat(ts)).reshape(8, 2)
    np.testing.assert_array_equal(flags.reshape(-1),
                                  np.asarray(jbuf.end_flag_flat(js)))
    assert flags[4].all()       # true episode end
    assert flags[5].all()       # the whole newest row forced True
    assert not flags[1].any()


def test_metrics_flat_channels():
    jbuf, js, tbuf, ts = _both(4, 2, [make_segment(0, 4, 2)])
    m = n(tbuf.metrics_flat(ts)).reshape(4, 2, 2)
    assert m[1, 0, 0] == 100.0            # reward channel
    assert abs(m[1, 0, 1] - 10.0) < 1e-5  # cost channel
    np.testing.assert_array_equal(m.reshape(-1, 2),
                                  np.asarray(jbuf.metrics_flat(js)))


def test_segment_longer_than_capacity_raises():
    tbuf = ReplayBuffer(4, 2, device="cpu")
    with pytest.raises(ValueError):
        tbuf.add_segment(tbuf.init(3, 2), _port(make_segment(0, 5, 2)))


def test_buffer_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        ReplayBuffer(8, 2)
