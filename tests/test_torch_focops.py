"""One FOCOPS update of the port against the JAX package, on the same
transitions, weights, per-epoch tile permutations and roll offsets."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (adam_state, full_vec, n, rollout_transitions,
                           scan_perms, state_dict, transition)

from fsrl_tpu.algos.focops import FOCOPS as JFOCOPS
from fsrl_tpu.types import minibatch_scan
from fsrl_torch.algos.common import split_flat
from fsrl_torch.algos.focops import FOCOPS
from fsrl_torch.types import minibatch_row_index

torch.set_num_threads(1)

D, A = 6, 2


@functools.lru_cache(maxsize=None)
def _params(hidden=(128, 128)):
    return jax.jit(JFOCOPS(D, A, hidden_sizes=hidden).init)(
        jax.random.PRNGKey(1)).params


# 300 rows: tile 1, the exact element shuffle; 8201 rows: tile 2 and one
# row left over, so every epoch rolls the batch by its own offset
@pytest.mark.parametrize("size,tile", [(300, 1), (8201, 2)])
def test_per_epoch_row_index_matches_jax_minibatch_scan(size, tile):
    rng = jax.random.PRNGKey(7)
    n_epochs, n_mb = 3, 4
    batch = {"i": jnp.arange(size, dtype=jnp.int32)[:, None]}
    rows_j = [np.asarray(minibatch_scan(
        key, batch, n_mb, lambda c, mb: (c, mb["i"][:, 0]), jnp.zeros(()))[1])
        for key in jax.random.split(rng, n_epochs)]
    perms, rolls, layout = scan_perms(rng, size, n_epochs, n_mb)
    assert layout.tile_size == tile
    assert layout.needs_roll == (size == 8201)
    if layout.needs_roll:
        assert len(set(rolls.tolist())) == n_epochs    # redrawn every epoch
    rows_t = minibatch_row_index(layout, perms, rolls)
    np.testing.assert_array_equal(n(rows_t), np.concatenate(rows_j))
    per_epoch = n(rows_t).reshape(n_epochs, -1)
    for e in range(n_epochs):
        assert len(set(per_epoch[e].tolist())) == per_epoch.shape[1]


CASES = {
    "plain": dict(),
    # the actor's Adam clips the gradient norm, the critics' does not
    "grad_clip": dict(max_grad_norm=0.05),
    # the mean KL after epoch 1 exceeds delta: epoch 2 is frozen
    "early_stop": dict(delta=1e-9),
    # a collect without a finished episode holds nu and last_ep_cost
    "no_episode": dict(),
    "no_adv_norm": dict(advantage_normalization=False),
    # 59 x 139 = 8201 rows: tile 2, a fresh roll each epoch
    "rolled": dict(),
    "bf16": dict(),
}


@pytest.mark.parametrize("case", list(CASES))
def test_update_matches_jax(case):
    kw = dict(repeat=2, n_minibatches=2, cost_limit=5.0)
    kw.update(CASES[case])
    T, N = (59, 139) if case == "rolled" else (16, 32)
    hidden = (32, 32) if case == "rolled" else (128, 128)
    bf16 = case == "bf16"
    jtr = rollout_transitions(T, N, D, A, seed=2)
    params = _params(hidden)
    jalgo = JFOCOPS(D, A, hidden_sizes=hidden,
                    compute_dtype=jnp.bfloat16 if bf16 else None, **kw)
    talgo = FOCOPS(D, A, hidden_sizes=hidden, device="cpu",
                   compute_dtype=torch.bfloat16 if bf16 else None, **kw)
    jstate = jalgo.init(jax.random.PRNGKey(0)).replace(
        params=params, nu=jnp.asarray(0.3), last_ep_cost=jnp.asarray([4.0]))
    tstate = talgo.init(state_dict=state_dict(params))
    tstate.nu, tstate.last_ep_cost = torch.tensor(0.3), torch.tensor([4.0])
    n_ep = 0 if case == "no_episode" else 3
    rng = jax.random.PRNGKey(5)
    jnew, jm = jax.jit(jalgo.update)(jstate, jtr, jnp.asarray([7.0]),
                                     jnp.asarray(n_ep, jnp.int32), rng)
    perms, rolls, layout = scan_perms(rng, T * N, 2, 2)
    assert layout.needs_roll == (case == "rolled")
    tnew, tm = talgo.update(tstate, transition(jtr), torch.tensor([7.0]),
                            torch.tensor(n_ep, dtype=torch.int32), None,
                            perms=(perms, rolls))
    assert set(tm) == set(jm)
    # f32: losses agree to the summation order, 1e-4 relative (the KL and
    # the surrogate are means of near-cancelling terms: 1e-6 absolute).
    # Measured 2e-5 relative. bf16: both sides round the same f32 values
    # to bf16, but a sum taken in another order can round to the
    # neighbouring bf16 value: held to 1e-3 (measured 6e-6 here)
    rel, ab = (1e-3, 1e-5) if bf16 else (1e-4, 1e-6)
    for k in jm:
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=rel, abs=ab), k
    assert int(tnew.gradient_steps) == int(jnew.gradient_steps)
    assert int(tnew.update_count) == 1
    np.testing.assert_allclose(n(tnew.nu), np.asarray(jnew.nu), rtol=1e-6)
    np.testing.assert_allclose(n(tnew.last_ep_cost),
                               np.asarray(jnew.last_ep_cost), rtol=1e-6)
    if case == "no_episode":
        assert float(tnew.nu) == pytest.approx(0.3)
        assert float(tnew.last_ep_cost[0]) == 4.0
    else:
        # nu - nu_lr * (limit - cost) = 0.3 - 0.01 * (5 - 7)
        assert float(tnew.nu) == pytest.approx(0.32)
    ja, jc = adam_state(jnew.actor_opt_state), adam_state(jnew.critic_opt_state)
    if case == "early_stop":
        assert float(tm["update/early_stopped"]) == 1.0
        assert int(tnew.gradient_steps) == 2
    else:
        assert float(tm["update/early_stopped"]) == 0.0
        assert int(tnew.gradient_steps) == 4
    assert int(tnew.actor_opt_state.count) == int(ja.count)
    assert int(tnew.critic_opt_state.count) == int(jc.count)
    assert int(ja.count) == int(tnew.gradient_steps)

    model = tnew.params
    # f32 sums in another order give gradients ~1e-7 apart relative; Adam's
    # lr * m / sqrt(v) passes that on, so after 4 steps of lr 3e-4 the
    # weights agree to 1e-5 absolute (measured 3e-7; the moves are ~1e-3).
    # bf16: a gradient entry can differ by 1e-2 of its size, and Adam's
    # first steps turn a sign flip of a near-zero entry into a full step
    # of lr 3e-4: held to 2e-4 (measured 2e-5)
    tol = 2e-4 if bf16 else 1e-5
    jflat = full_vec(model, jax.device_get(jnew.params))
    worst = float((tnew.flat - jflat).abs().max())
    assert worst < tol, worst
    moved = float((jflat - full_vec(model, jax.device_get(params))).abs().max())
    assert moved > 1e-4
    if bf16:
        return
    # both Adam states, as the actor half and the critic half of the vector
    for name, rtol in (("mu", 1e-4), ("nu", 1e-4)):
        jvec = full_vec(model, {"actor": getattr(ja, name),
                                "critics": getattr(jc, name)})
        tvec = torch.cat([getattr(tnew.actor_opt_state, name),
                          getattr(tnew.critic_opt_state, name)])
        scale = float(jvec.abs().max())
        np.testing.assert_allclose(n(tvec), n(jvec), rtol=rtol,
                                   atol=1e-5 * scale, err_msg=name)
    n_actor = split_flat(model, tnew.flat)[0].numel()
    assert tnew.actor_opt_state.mu.numel() == n_actor


def test_frozen_steps_still_report_metrics():
    """After the stop the parameters stay put, but every grad step's loss
    still enters the metric means, as in the JAX scan."""
    talgo = FOCOPS(D, A, device="cpu", repeat=3, n_minibatches=2, delta=1e-9)
    tstate = talgo.init(seed=0)
    tr = transition(rollout_transitions(16, 32, D, A, seed=3))
    g = torch.Generator().manual_seed(0)
    tnew, tm = talgo.update(tstate, tr, torch.tensor([7.0]),
                            torch.tensor(2, dtype=torch.int32), g)
    assert int(tnew.gradient_steps) == 2
    assert int(tnew.actor_opt_state.count) == 2
    assert int(tnew.critic_opt_state.count) == 2
    assert float(tm["loss/kl"]) > 0
    assert all(torch.isfinite(v) for v in tm.values())
