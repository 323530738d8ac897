"""Rollout processing, the minibatch shuffle and one whole PPO-Lag update of
the port against the JAX package, on the same transitions, weights and
tile permutations."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import n, state_dict, t, transition

from fsrl_tpu.algos.common import process_rollout as j_process
from fsrl_tpu.algos.ppo_lag import PPOLag as JPPOLag
from fsrl_tpu.ops.running_stats import RunningMeanStd as JRMS
from fsrl_tpu.types import Transition as JTransition
from fsrl_tpu.types import minibatch_epochs_scan
from fsrl_torch.algos.common import process_rollout
from fsrl_torch.algos.ppo_lag import PPOLag
from fsrl_torch.ops.running_stats import RunningMeanStd
from fsrl_torch.types import TileLayout, minibatch_row_index
from fsrl_torch.utils.params import to_jax_params

torch.set_num_threads(1)

D, A = 6, 2


def _transitions(T, N, M=1, seed=0, p_term=0.03, p_trunc=0.1):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    term = rng.random((T, N)) < p_term
    trunc = (rng.random((T, N)) < p_trunc) & ~term
    return JTransition(
        obs=jnp.asarray(f(T, N, D)), act=jnp.asarray(f(T, N, A)),
        obs_next=jnp.asarray(f(T, N, D)), reward=jnp.asarray(f(T, N)),
        cost=jnp.asarray(rng.random((T, N, M)).astype(np.float32)),
        terminated=jnp.asarray(term), truncated=jnp.asarray(trunc),
        logp=jnp.asarray(f(T, N) - 2.0))


@functools.lru_cache(maxsize=None)
def _params(M: int, hidden=(128, 128)):
    jalgo = JPPOLag(D, A, num_costs=M, hidden_sizes=hidden)
    return jax.jit(jalgo.init)(jax.random.PRNGKey(M)).params


# episode_len=5 at T=12 allows 3 truncations per env column; p_trunc 0.3
# makes more, so the one-pass path also drops rows past its budget
@pytest.mark.parametrize("episode_len", [None, 5], ids=["two_pass", "one_pass"])
@pytest.mark.parametrize("rew_norm", [False, True], ids=["raw", "rew_norm"])
def test_process_rollout_matches_jax(episode_len, rew_norm):
    T, N = 12, 10
    jtr = _transitions(T, N, seed=1, p_trunc=0.3)
    params = _params(1)
    jalgo = JPPOLag(D, A)
    talgo = PPOLag(D, A, device="cpu")
    state = talgo.init(state_dict=state_dict(params))
    jcrit = lambda p, o: jalgo.critics.apply(p["critics"], o)
    if rew_norm:
        jrms = JRMS(mean=jnp.asarray([0.1, -0.2]), var=jnp.asarray([2.0, 0.5]),
                    count=jnp.asarray(30.0))
        jb, jrms2 = j_process(jcrit, params, jtr, 0.99, 0.95,
                              gae_impl="scan", ret_rms=jrms,
                              episode_len=episode_len)
        trms = RunningMeanStd(mean=t(jrms.mean), var=t(jrms.var),
                              count=t(jrms.count))
        tb, trms2 = process_rollout(state.params.critics, transition(jtr),
                                    0.99, 0.95, ret_rms=trms,
                                    episode_len=episode_len)
        for name in ("mean", "var", "count"):
            np.testing.assert_allclose(n(getattr(trms2, name)),
                                       np.asarray(getattr(jrms2, name)),
                                       rtol=1e-5, atol=1e-6)
    else:
        jb = j_process(jcrit, params, jtr, 0.99, 0.95, gae_impl="scan",
                       episode_len=episode_len)
        tb = process_rollout(state.params.critics, transition(jtr), 0.99,
                             0.95, episode_len=episode_len)
    # critic matmuls sum in another order: 1e-5 relative, and GAE carries
    # that over up to 12 steps
    for name in ("obs", "act", "logp_old", "adv", "ret", "value_old"):
        np.testing.assert_allclose(n(getattr(tb, name)),
                                   np.asarray(getattr(jb, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def _jax_perms(rng, size, n_epochs, n_mb):
    """The tile permutations and roll offset ``minibatch_epochs_scan``
    draws from ``rng`` (fsrl_tpu/types.py:363-373), one block."""
    layout = TileLayout.of(size, n_mb)
    _, k_perm, k_roll = jax.random.split(rng, 3)
    keys = jax.random.split(k_perm, n_epochs)
    perms = jax.vmap(lambda k: jax.random.permutation(
        k, layout.n_tiles)[: layout.usable])(keys)
    roll = (jax.random.randint(k_roll, (), 0, size) if layout.needs_roll
            else 0)
    return t(perms).long(), torch.tensor(int(roll)), layout


# 300 rows: tile 1; 8200 rows: tile 2 with 8 rows left over (the roll)
@pytest.mark.parametrize("size,tile", [(300, 1), (8200, 2)])
def test_row_index_matches_jax_shuffle(size, tile):
    """The port's row index reproduces the minibatches JAX's
    ``minibatch_epochs_scan`` forms from the same key."""
    rng = jax.random.PRNGKey(4)
    n_epochs, n_mb = 3, 4
    batch = {"i": jnp.arange(size, dtype=jnp.int32)[:, None]}
    _, rows_j = minibatch_epochs_scan(
        rng, batch, n_epochs, n_mb, lambda c, mb, e: (c, mb["i"][:, 0]),
        jnp.zeros(()), per_leaf=True)
    perms, roll, layout = _jax_perms(rng, size, n_epochs, n_mb)
    assert layout.tile_size == tile
    rows_t = minibatch_row_index(layout, perms, roll)
    np.testing.assert_array_equal(n(rows_t), np.asarray(rows_j))
    # each sample at most once per epoch, every epoch the same count
    per_epoch = n(rows_t).reshape(n_epochs, -1)
    for e in range(n_epochs):
        assert len(set(per_epoch[e].tolist())) == per_epoch.shape[1]
    assert per_epoch.shape[1] == layout.usable * tile


def test_shuffle_covers_every_sample_once_per_epoch():
    layout = TileLayout.of(64 * 4096, 8)
    assert (layout.tile_size, layout.n_tiles, layout.mb_rows) == \
        (64, 4096, 32768)
    from fsrl_torch.types import draw_tile_perms
    perms, roll = draw_tile_perms(layout, 4, torch.Generator().manual_seed(0),
                                  "cpu")
    rows = minibatch_row_index(layout, perms, roll).reshape(4, -1)
    for e in range(4):
        assert torch.equal(torch.sort(rows[e]).values,
                           torch.arange(layout.size))


UPDATE_CASES = {
    # the fused-grad path (kernel K2's plain version on the CPU)
    "kernel_path": dict(),
    "kernel_path_2costs": dict(num_costs=2, cost_limit=[5.0, 3.0]),
    # KL early stop after the first epoch: later steps frozen
    "early_stop": dict(target_kl=1e-7),
    # outside the kernel's envelope: autograd of the plain loss
    "autograd_dual_clip": dict(dual_clip=3.0),
}


@pytest.mark.parametrize("case", list(UPDATE_CASES))
def test_update_matches_jax(case):
    kw = dict(repeat=2, n_minibatches=2, cost_limit=5.0)
    kw.update(UPDATE_CASES[case])
    M = kw.get("num_costs", 1)
    T, N = 16, 32
    jtr = _transitions(T, N, M=M, seed=2)
    params = _params(M)
    jalgo = JPPOLag(D, A, gae_impl="scan", **kw)
    talgo = PPOLag(D, A, device="cpu", **kw)
    assert talgo.use_grad_kernel == (case != "autograd_dual_clip")
    jstate = jalgo.init(jax.random.PRNGKey(0)).replace(params=params)
    tstate = talgo.init(state_dict=state_dict(params))
    ep_cost = np.linspace(7.0, 2.0, M).astype(np.float32)
    rng = jax.random.PRNGKey(5)
    jnew, jm = jax.jit(jalgo.update)(jstate, jtr, jnp.asarray(ep_cost),
                                     jnp.asarray(3, jnp.int32), rng)
    perms, roll, _ = _jax_perms(rng, T * N, 2, 2)
    tnew, tm = talgo.update(tstate, transition(jtr), t(ep_cost),
                            torch.tensor(3, dtype=torch.int32), None,
                            perms=(perms, roll))
    assert set(tm) == set(jm)
    # per-step losses agree to f32 summation order; the KL and the
    # surrogate are means of near-cancelling terms, so also 1e-6 absolute
    for k in jm:
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-4,
                                             abs=1e-6), k
    assert int(tnew.gradient_steps) == int(jnew.gradient_steps)
    if case == "early_stop":
        assert float(tm["update/early_stopped"]) == 1.0
        assert int(tnew.gradient_steps) == 2
        assert int(tnew.opt_state.count) == 2
    # f32 sums in another order give gradients ~1e-7 apart relative; Adam's
    # step (lr * m / sqrt(v)) passes that on, so after 4 steps of lr 5e-4
    # the weights agree to 1e-5 absolute (the moves themselves are ~1e-3)
    jp = jax.tree.leaves(jax.device_get(jnew.params))
    tp = jax.tree.leaves(to_jax_params(tnew.params.state_dict()))
    worst = max(float(np.abs(a - np.asarray(b)).max()) for a, b in zip(tp, jp))
    assert worst < 1e-5, worst
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                for a, b in zip(jp, jax.tree.leaves(jax.device_get(params))))
    assert moved > 1e-4
    for name in ("error_old", "error_integral", "multiplier", "cost_ema",
                 "ema_n"):
        np.testing.assert_allclose(n(getattr(tnew.lag, name)),
                                   np.asarray(getattr(jnew.lag, name)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    np.testing.assert_allclose(n(tnew.last_ep_cost),
                               np.asarray(jnew.last_ep_cost), rtol=1e-6)
