"""n-step targets of the port against the JAX package: the hand-checked
cases of ``tests/test_ops.py``, random chains through a wrapped ring buffer
with n_step 1 to 3 and K 2 to 3 channels, and the whole sampler
(``make_nstep_view`` + ``sample_nstep_batch``) with JAX's draws injected.

Chains are integer gathers and must be equal. The returns are the same
f32 recurrence; XLA may contract ``m + gamma * r`` into an FMA, so they are
held to rtol 1e-6."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import n, t
from test_torch_buffer import _both, make_segment

from fsrl_torch.algos.offpolicy_base import (make_nstep_view,
                                             sample_nstep_batch)
from fsrl_torch.ops.nstep import nstep_forward_indices, nstep_targets
from fsrl_tpu.algos.offpolicy_base import make_nstep_view as j_view
from fsrl_tpu.algos.offpolicy_base import sample_nstep_batch as j_sample
from fsrl_tpu.ops.nstep import nstep_forward_indices as j_chain
from fsrl_tpu.ops.nstep import nstep_targets as j_targets


def test_nstep_targets_match_naive():
    """One env, a 2-step target across an episode break (the JAX test)."""
    metrics = torch.tensor([[1.0], [2.0], [4.0], [8.0]])
    end = torch.tensor([False, True, False, False])
    next_flat = torch.tensor([1, 2, 3, 3])
    chain = nstep_forward_indices(torch.tensor([0, 2]), next_flat, 2)
    np.testing.assert_array_equal(n(chain), [[0, 2], [1, 3]])
    got = nstep_targets(metrics, end, torch.tensor([[10.0], [20.0]]), chain,
                        0.5)
    assert float(got[0, 0]) == pytest.approx(1 + 0.5 * 2 + 0.25 * 10)
    assert float(got[1, 0]) == pytest.approx(4 + 0.5 * 8 + 0.25 * 20)


def test_nstep_end_resets_gamma_exponent():
    """An end at the chain's first step: only r0 counts, bootstrap
    gamma^1."""
    chain = nstep_forward_indices(torch.tensor([0]), torch.tensor([1, 1]), 2)
    got = nstep_targets(torch.tensor([[5.0], [7.0]]),
                        torch.tensor([True, False]),
                        torch.tensor([[100.0]]), chain, 0.5)
    assert float(got[0, 0]) == pytest.approx(5 + 0.5 * 100)


@pytest.mark.parametrize("n_step", [1, 2, 3])
@pytest.mark.parametrize("K", [2, 3])
def test_random_chains_match_jax(n_step, K):
    rng = np.random.default_rng(10 * n_step + K)
    C, N, B = 12, 4, 64
    # a ring-like successor map: next row of the same env, stalling at
    # random episode ends and at a newest row
    done = rng.random((C, N)) < 0.2
    done[7] = True
    rows, envs = np.arange(C)[:, None], np.arange(N)[None, :]
    nxt = np.where(done, rows * N + envs, ((rows + 1) % C) * N + envs)
    next_flat = nxt.reshape(-1).astype(np.int32)
    end = done.reshape(-1)
    metrics = rng.normal(size=(C * N, K)).astype(np.float32)
    idx = rng.integers(0, C * N, B).astype(np.int32)
    target_q = rng.normal(size=(B, K)).astype(np.float32)
    jc = np.asarray(j_chain(jnp.asarray(idx), jnp.asarray(next_flat), n_step))
    tc = nstep_forward_indices(torch.from_numpy(idx).long(),
                               torch.from_numpy(next_flat).long(), n_step)
    np.testing.assert_array_equal(n(tc), jc)
    for gamma in (0.99, 0.5):
        want = np.asarray(j_targets(jnp.asarray(metrics), jnp.asarray(end),
                                    jnp.asarray(target_q), jnp.asarray(jc),
                                    gamma))
        got = nstep_targets(torch.from_numpy(metrics), torch.from_numpy(end),
                            torch.from_numpy(target_q), tc, gamma)
        np.testing.assert_allclose(n(got), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n_step", [1, 2, 3])
def test_sample_nstep_batch_matches_jax(n_step):
    """The whole sampler on a wrapped buffer with terminations: JAX's
    indices (rows from ``rng``, envs from ``fold_in(rng, 1)``) injected, a
    target-Q function of ``obs_next`` on both sides; the terminal rows'
    targets are masked where terminated."""
    N = 3
    segs = [make_segment(t0, 5, N, seed=t0 + n_step) for t0 in (0, 5, 10)]
    jbuf, js, tbuf, ts = _both(8, N, segs)
    B, gamma = 48, 0.9
    w = np.linspace(-1.0, 1.0, 6, dtype=np.float32).reshape(3, 2)

    def j_q(term):
        return term.obs_next @ jnp.asarray(w)

    def t_q(term):
        return term["obs_next"] @ torch.from_numpy(w)

    rng = jax.random.PRNGKey(n_step)
    jbatch, jrets = j_sample(jbuf, js, rng, B, n_step, gamma, j_q,
                             view=j_view(jbuf, js))
    rows = jax.random.randint(rng, (B,), 0, js.filled)
    envs = jax.random.randint(jax.random.fold_in(rng, 1), (B,), 0, N)
    view = make_nstep_view(tbuf, ts)
    for f in dataclasses.fields(view):
        np.testing.assert_array_equal(
            n(getattr(view, f.name)),
            np.asarray(getattr(j_view(jbuf, js), f.name)), err_msg=f.name)
    tbatch, trets = sample_nstep_batch(
        tbuf, ts, None, B, n_step, gamma, t_q, view,
        dict(rows=t(rows).long(), envs=t(envs).long()))
    np.testing.assert_array_equal(n(tbatch["obs"]), np.asarray(jbatch.obs))
    np.testing.assert_array_equal(n(tbatch["act"]), np.asarray(jbatch.act))
    np.testing.assert_allclose(n(trets), np.asarray(jrets), rtol=1e-6,
                               atol=1e-5)
    # without a view the sampler builds its own
    _, again = sample_nstep_batch(tbuf, ts, None, B, n_step, gamma, t_q,
                                  None, dict(rows=t(rows).long(),
                                             envs=t(envs).long()))
    assert torch.equal(again, trets)
