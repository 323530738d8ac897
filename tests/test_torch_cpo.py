"""CPO of the port against the JAX package: the trust-region step (q, r, s,
A, B, ``optim_case``, lam, nu, step, beta and the new parameters) with
inputs that reach every optimization case, and one whole update."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (actor_vec, adam_state, full_vec, n,
                           rollout_transitions, state_dict, transition)

from fsrl_tpu.algos.cpo import CPO as JCPO
from fsrl_torch.algos import cpo as tcpo
from fsrl_torch.algos.common import split_flat
from fsrl_torch.algos.cpo import CPO

torch.set_num_threads(1)

D, A = 6, 2
HIDDEN = (64, 64)
DELTA = 0.01


@functools.lru_cache(maxsize=None)
def _params():
    return jax.jit(JCPO(D, A, hidden_sizes=HIDDEN).init)(
        jax.random.PRNGKey(3)).params


@functools.lru_cache(maxsize=None)
def _batch(B=512, seed=0):
    """Rows whose ``logp_old`` is the actor's own log-prob plus noise, so
    the ratios sit near 1 as after a collect."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    obs, adv = f(B, D), f(B, 2)
    adv = (adv - adv.mean(0)) / (adv.std(0) + 1e-8)
    jalgo = JCPO(D, A, hidden_sizes=HIDDEN)
    dist = jalgo.actor.apply(_params()["actor"], obs)
    act = np.asarray(dist.mean) + 0.6 * f(B, A)
    logp = np.asarray(dist.log_prob(act)) + 0.05 * f(B)
    return dict(obs=obs, act=act.astype(np.float32),
                logp_old=logp.astype(np.float32), advR=adv[:, 0].copy(),
                advC=adv[:, 1].copy())


# c = cost surrogate - limit decides the case together with B = 2 delta -
# c^2 / s; s is ~2e-2 here, so |c| = 0.005 keeps B >= 0 and |c| = 10 does not
STEP_CASES = {
    "case0_recovery": dict(c=10.0, want=0),
    "case1_infeasible": dict(c=0.005, want=1),
    "case2_feasible": dict(c=-0.005, want=2),
    "case3_far_feasible": dict(c=-10.0, want=3),
    "case4_no_cost_gradient": dict(c=-10.0, want=4, zero_advC=True),
    # no reward gradient and a zero trust region: lam = sqrt(0 / 0)
    "nan_guard": dict(c=-10.0, want=3, nan=True, delta=0.0),
    "bf16": dict(c=-0.005, want=2),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_trust_region_step_matches_jax(case):
    spec = STEP_CASES[case]
    bf16 = case == "bf16"
    params = _params()
    delta = spec.get("delta", DELTA)
    kw = dict(hidden_sizes=HIDDEN, target_kl=delta)
    jalgo = JCPO(D, A, compute_dtype=jnp.bfloat16 if bf16 else None, **kw)
    talgo = CPO(D, A, compute_dtype=torch.bfloat16 if bf16 else None,
                device="cpu", **kw)
    tstate = talgo.init(state_dict=state_dict(params))
    model = tstate.params
    b = dict(_batch())
    if spec.get("zero_advC"):
        b["advC"] = np.zeros_like(b["advC"])
    if spec.get("nan"):
        b["advR"] = np.zeros_like(b["advR"])
    ave_cost = np.float32(20.0)
    jstep = jax.jit(jalgo._tr_step, static_argnums=(8,))
    jargs = (params["actor"], b["obs"], b["act"], b["logp_old"], b["advR"],
             b["advC"], jnp.asarray(ave_cost))
    # the cost surrogate does not depend on the limit: read it, then place
    # the limit at the wanted distance
    surr0 = float(jstep(*jargs, jnp.asarray(0.0), delta)[1]["loss/cost_loss"])
    limit = np.float32(surr0 - spec["c"])
    jnew, jm = jstep(*jargs, jnp.asarray(limit), delta)
    flat_a = split_flat(model, tstate.flat)[0]
    start = flat_a.clone()
    tnew, tm = talgo.trust_region_step(
        model, flat_a, *(torch.from_numpy(b[k]) for k in
                         ("obs", "act", "logp_old", "advR", "advC")),
        torch.tensor(ave_cost), torch.tensor(limit))
    assert torch.equal(flat_a, start)
    assert set(tm) == set(jm)
    assert int(jm["loss/optim_case"]) == spec["want"]
    move_t = tnew - start
    move_j = actor_vec(model, jnew, params) - start
    if spec.get("nan"):
        # lambda is NaN: the guard sets beta to 0 on both sides (and the
        # NaN direction still reaches the parameters on both sides)
        for m in (tm, jm):
            assert np.isnan(float(m["loss/optim_lam"]))
            assert float(m["loss/step_size"]) == 0.0
            assert float(m["loss/ls_ok"]) == 0.0
            assert int(m["loss/backtracks"]) == talgo.hp["max_backtracks"] - 1
        assert bool(torch.isnan(move_t).all()) and bool(
            torch.isnan(move_j).all())
        return
    cos = float(torch.dot(move_t, move_j) / (move_t.norm() * move_j.norm()))
    if bf16:
        # two CG solves through twice-differentiated bf16 casts: cosine
        # 0.95 or better (measured 1 - cos 2e-7); the accepted index may
        # differ by the rounding of one comparison, so the length only
        # within one backtrack
        assert cos > 1 - 5e-2, cos
        assert 0.79 < float(move_t.norm() / move_j.norm()) < 1.27
        return
    assert int(tm["loss/optim_case"]) == spec["want"]
    assert int(tm["loss/backtracks"]) == int(jm["loss/backtracks"])
    assert float(tm["loss/ls_ok"]) == float(jm["loss/ls_ok"]) == 1.0
    # q, r, s are quadratic forms of two CG solutions that ten iterations
    # leave unconverged (see test_torch_cg.py; H^-1 b is the worse of the
    # two), A, B, lam, nu follow from them: 1e-2 relative (measured
    # 1.5e-3 at worst, on r, a cross term); beta is a power of 0.8:
    # exact to 1e-6
    for k in jm:
        rel = 1e-6 if k in ("loss/step_size", "loss/backtracks") else 1e-2
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=rel,
                                             abs=2e-6), k
    # the step has unit norm times beta: 5e-3 of its length (measured
    # 2.3e-3 in the recovery case, whose direction is H^-1 b alone)
    assert float(move_t.norm()) == pytest.approx(
        float(tm["loss/step_size"]), rel=1e-4)
    assert float((move_t - move_j).norm() / move_j.norm()) < 5e-3
    assert cos > 1 - 2e-5


def test_line_search_group_boundary(monkeypatch):
    """The accepted index does not depend on how many candidates are
    evaluated between two host syncs."""
    params = _params()
    b = _batch()
    out = {}
    for group in (1, 3, 10, 200):
        monkeypatch.setattr(tcpo, "LS_GROUP", group)
        talgo = CPO(D, A, hidden_sizes=HIDDEN, target_kl=DELTA, device="cpu")
        tstate = talgo.init(state_dict=state_dict(params))
        tnew, tm = talgo.trust_region_step(
            tstate.params, split_flat(tstate.params, tstate.flat)[0],
            *(torch.from_numpy(b[k]) for k in
              ("obs", "act", "logp_old", "advR", "advC")),
            torch.tensor(20.0), torch.tensor(30.0))
        out[group] = (tnew, int(tm["loss/backtracks"]))
    assert out[1][1] > 3          # the search crosses a group boundary
    for group in (3, 10, 200):
        assert out[group][1] == out[1][1]
        assert torch.equal(out[group][0], out[1][0])


UPDATE_CASES = {
    "default": dict(),
    "repeat2": dict(repeat=2, optim_critic_iters=5),
    "no_episode": dict(),
}


@pytest.mark.parametrize("case", list(UPDATE_CASES))
def test_update_matches_jax(case):
    kw = dict(hidden_sizes=HIDDEN, target_kl=DELTA, cost_limit=5.0)
    kw.update(UPDATE_CASES[case])
    T, N = 16, 32
    jtr = rollout_transitions(T, N, D, A, seed=2)
    params = _params()
    jalgo, talgo = JCPO(D, A, **kw), CPO(D, A, device="cpu", **kw)
    jstate = jalgo.init(jax.random.PRNGKey(0)).replace(
        params=params, last_ep_cost=jnp.asarray([4.0]))
    tstate = talgo.init(state_dict=state_dict(params))
    tstate.last_ep_cost = torch.tensor([4.0])
    n_ep = 0 if case == "no_episode" else 3
    jnew, jm = jax.jit(jalgo.update)(jstate, jtr, jnp.asarray([7.0]),
                                     jnp.asarray(n_ep, jnp.int32),
                                     jax.random.PRNGKey(5))
    tnew, tm = talgo.update(tstate, transition(jtr), torch.tensor([7.0]),
                            torch.tensor(n_ep, dtype=torch.int32))
    assert set(tm) == set(jm)
    for k in ("loss/optim_case", "loss/backtracks", "loss/ls_ok",
              "update/line_search_ok"):
        assert float(tm[k]) == float(jm[k]), k
    # as in the step test: 1e-2 on what follows from the CG solutions
    # (measured 1.5e-3 at worst), but 5e-2 on r = g^T H^-1 b (measured
    # 2e-2 with repeat 2): g and H^-1 b are nearly orthogonal here, so r
    # multiplies the 2e-3 of H^-1 b, whose CG stops where its squared
    # residual crosses 1e-8, by the inverse of their cosine
    for k in jm:
        rel = 5e-2 if k == "loss/optim_R" else 1e-2
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=rel,
                                             abs=2e-6), k
    iters = kw.get("repeat", 1) * kw.get("optim_critic_iters", 10)
    assert int(tnew.gradient_steps) == int(jnew.gradient_steps) == iters
    assert float(tnew.last_ep_cost[0]) == float(jnew.last_ep_cost[0]) == (
        4.0 if case == "no_episode" else 7.0)
    model = tnew.params
    jflat = full_vec(model, jax.device_get(jnew.params))
    start = full_vec(model, jax.device_get(params))
    (ja, jc), (ta, tc) = split_flat(model, jflat), split_flat(model, tnew.flat)
    sa = split_flat(model, start)[0]
    # the actor's step: 5e-3 of its length (measured 6e-4 to 2e-3)
    assert float((ta - ja).norm() / (ja - sa).norm()) < 5e-3
    # the critics after their Adam steps with the L2 term: 2e-5 absolute
    # (measured 5e-8; they move by ~1e-2)
    assert float((tc - jc).abs().max()) < 2e-5
    jadam = adam_state(jnew.critic_opt_state)
    assert int(tnew.critic_opt_state.count) == int(jadam.count) == iters
    for name in ("mu", "nu"):
        jvec = split_flat(model, full_vec(model, {
            "actor": params["actor"], "critics": getattr(jadam, name)}))[1]
        np.testing.assert_allclose(
            n(getattr(tnew.critic_opt_state, name)), n(jvec), rtol=1e-3,
            atol=1e-5 * float(jvec.abs().max()), err_msg=name)
