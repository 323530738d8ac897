"""TRPO-Lagrangian of the port against the JAX package: the natural
gradient step (search direction, ``shs``, step size, accepted line-search
index, new actor parameters) and one whole update (critics after their Adam
steps, PID state, metrics), on the same transitions and weights."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (actor_vec, adam_state, full_vec, n,
                           rollout_transitions, state_dict, t, transition)
from jax.flatten_util import ravel_pytree

from fsrl_tpu.algos.trpo_lag import TRPOLag as JTRPOLag
from fsrl_tpu.ops.cg import conjugate_gradient as j_cg
from fsrl_torch.algos.common import split_flat
from fsrl_torch.algos.trpo_lag import TRPOLag

torch.set_num_threads(1)

D, A = 6, 2
HIDDEN = (64, 64)


@functools.lru_cache(maxsize=None)
def _params(M: int, log_sigma=None):
    jalgo = JTRPOLag(D, A, num_costs=M, hidden_sizes=HIDDEN)
    params = jax.jit(jalgo.init)(jax.random.PRNGKey(M)).params
    if log_sigma is not None:
        params = jax.tree.map(lambda x: x, params)
        params["actor"]["params"]["log_sigma"] = jnp.full((A,), log_sigma)
    return params


def _batch(M, B=512, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    adv = f(B, 1 + M)
    adv = (adv - adv.mean(0)) / (adv.std(0) + 1e-8)
    return dict(obs=f(B, D), act=0.5 * f(B, A), logp_old=f(B) * 0.1 - 2.0,
                adv=adv)


def _jax_step(jalgo, actor_params, b, lam, resc):
    """JAX's step, and beside it the quantities its info leaves out: the
    search direction (as an actor tree), ``shs`` and the accepted index."""
    hp = jalgo.hp
    new, info = jax.jit(jalgo.natural_gradient_step)(
        actor_params, b["obs"], b["act"], b["logp_old"], b["adv"], lam, resc)
    flat0, unravel = ravel_pytree(actor_params)
    old = jalgo.actor.apply(actor_params, b["obs"])
    loss = lambda f: jalgo._actor_loss(unravel(f), b["obs"], b["act"],
                                       b["logp_old"], b["adv"], lam, resc)
    kl = lambda f: jnp.mean(old.kl(jalgo.actor.apply(unravel(f), b["obs"])))
    fvp = lambda v: jax.jvp(jax.grad(kl), (flat0,), (v,))[1] \
        + hp["damping"] * v
    direction = -j_cg(fvp, jax.grad(loss)(flat0), hp["cg_iters"])
    shs = float(jnp.dot(direction, fvp(direction)))
    full = np.sqrt(2 * hp["target_kl"] / max(shs, 1e-12))
    idx = int(round(np.log(float(info["step_size"]) / full)
                    / np.log(hp["backtrack_coeff"])))
    return new, info, unravel(direction), shs, idx


STEP_CASES = {
    "default": dict(),
    "two_costs": dict(num_costs=2, cost_limit=[5.0, 3.0]),
    "no_lagrangian": dict(use_lagrangian=False),
    # a trust region far beyond the quadratic model's reach: the step
    # collapses sigma, the true KL is 300 times the target at every
    # candidate, and the smallest step is applied
    "all_fail": dict(target_kl=1e3, max_backtracks=3),
    # log_sigma exactly at log(floor): maximum's gradient splits 0.5 / 0.5
    "sigma_floor_tie": dict(sigma_floor=1.0),
    "bf16": dict(),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_natural_gradient_step_matches_jax(case):
    kw = dict(hidden_sizes=HIDDEN, target_kl=0.01)
    kw.update(STEP_CASES[case])
    M = kw.get("num_costs", 1)
    bf16 = case == "bf16"
    params = _params(M, 0.0 if case == "sigma_floor_tie" else None)
    jalgo = JTRPOLag(D, A, compute_dtype=jnp.bfloat16 if bf16 else None, **kw)
    talgo = TRPOLag(D, A, compute_dtype=torch.bfloat16 if bf16 else None,
                    device="cpu", **kw)
    tstate = talgo.init(state_dict=state_dict(params))
    model = tstate.params
    b = _batch(M)
    lam = np.linspace(0.5, 1.5, M).astype(np.float32)
    resc = np.float32(1.0 / (lam.sum() + 1.0))
    jnew, jinfo, jdir, jshs, jidx = _jax_step(
        jalgo, params["actor"], b, jnp.asarray(lam), jnp.asarray(resc))
    flat_a = split_flat(model, tstate.flat)[0]
    start = flat_a.clone()
    tnew, tinfo, tidx = talgo.natural_gradient_step(
        model, flat_a, *(torch.from_numpy(b[k]) for k in
                         ("obs", "act", "logp_old", "adv")),
        torch.from_numpy(lam), torch.tensor(resc))
    assert torch.equal(flat_a, start)           # the step returns, not writes
    assert set(tinfo) == set(jinfo)
    move_t = tnew - start
    move_j = actor_vec(model, jnew, params) - start
    cos = float(torch.dot(move_t, move_j) / (move_t.norm() * move_j.norm()))
    if bf16:
        # the FVP differentiates twice through the bf16 casts and CG
        # amplifies the rounding: the step as a whole is held to a cosine
        # of 0.95 (measured 1 - cos < 1e-7) and its length to 5e-2 (measured 8e-5)
        assert cos > 1 - 5e-2, cos
        assert float(move_t.norm()) == pytest.approx(float(move_j.norm()),
                                                     rel=5e-2)
        return
    idx = int(tidx)
    assert idx == jidx
    ok = float(tinfo["line_search_ok"])
    assert ok == float(jinfo["line_search_ok"])
    if case == "all_fail":
        assert ok == 0.0 and idx == kw["max_backtracks"] - 1
    else:
        assert ok == 1.0
    # search direction and shs, recovered from the applied step:
    # move = frac * sqrt(2 target / shs) * direction
    frac = kw.get("backtrack_coeff", 0.8) ** idx
    step_full = float(tinfo["step_size"]) / frac
    shs = 2 * kw["target_kl"] / step_full ** 2
    # shs is a quadratic form of the CG solution: measured 4e-6 to 3e-4
    assert shs == pytest.approx(jshs, rel=1e-3)
    dir_t = move_t / float(tinfo["step_size"])
    dir_j = actor_vec(model, jdir, params)
    # ten CG iterations amplify the f32 rounding of each product (see
    # test_torch_cg.py): 1e-3 of the direction's norm, measured 3e-6 to
    # 3e-4 over the cases
    assert float((dir_t - dir_j).norm() / dir_j.norm()) < 1e-3
    assert cos > 1 - 1e-6
    # new actor parameters: 1e-3 of the step, measured 6e-6 to 3.4e-4
    assert float((move_t - move_j).norm() / move_j.norm()) < 1e-3
    for k in jinfo:
        # the all-fail case's KL is ~exp(2 * 6) of a sigma that the step
        # collapsed: it multiplies the step's 1e-4 by its own size
        rel = 5e-2 if (case, k) == ("all_fail", "kl") else 1e-3
        assert float(tinfo[k]) == pytest.approx(float(jinfo[k]), rel=rel,
                                                abs=1e-6), k
    if case == "sigma_floor_tie":
        # at the tie half of log_sigma's gradient passes: it moves (the
        # last A entries of the actor vector), and as in JAX
        assert float(move_t[-A:].abs().min()) > 0
        np.testing.assert_allclose(n(move_t[-A:]), n(move_j[-A:]), rtol=1e-3)


UPDATE_CASES = {
    "default": dict(),
    "two_costs": dict(num_costs=2, cost_limit=[5.0, 3.0]),
    "no_lagrangian": dict(use_lagrangian=False),
    "repeat2_exact_pid": dict(repeat=2, pid_filter=False,
                              optim_critic_iters=5),
}


@pytest.mark.parametrize("case", list(UPDATE_CASES))
def test_update_matches_jax(case):
    kw = dict(hidden_sizes=HIDDEN, target_kl=0.01, cost_limit=5.0)
    kw.update(UPDATE_CASES[case])
    M = kw.get("num_costs", 1)
    T, N = 16, 32
    jtr = rollout_transitions(T, N, D, A, M=M, seed=2)
    params = _params(M)
    jalgo = JTRPOLag(D, A, **kw)
    talgo = TRPOLag(D, A, device="cpu", **kw)
    jstate = jalgo.init(jax.random.PRNGKey(0)).replace(params=params)
    tstate = talgo.init(state_dict=state_dict(params))
    ep_cost = np.linspace(7.0, 2.0, M).astype(np.float32)
    jnew, jm = jax.jit(jalgo.update)(jstate, jtr, jnp.asarray(ep_cost),
                                     jnp.asarray(3, jnp.int32),
                                     jax.random.PRNGKey(5))
    tnew, tm = talgo.update(tstate, transition(jtr), t(ep_cost),
                            torch.tensor(3, dtype=torch.int32))
    assert set(tm) == set(jm)
    assert talgo.last_backtracks.shape == (kw.get("repeat", 1),)
    for k in jm:
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-3,
                                             abs=1e-6), k
    iters = kw.get("repeat", 1) * kw.get("optim_critic_iters", 20)
    assert int(tnew.gradient_steps) == int(jnew.gradient_steps) == iters
    assert int(tnew.critic_opt_state.count) == iters
    model = tnew.params
    jflat = full_vec(model, jax.device_get(jnew.params))
    start = full_vec(model, jax.device_get(params))
    ja, jc = split_flat(model, jflat)
    ta, tc = split_flat(model, tnew.flat)
    sa, _ = split_flat(model, start)
    # the actor's step, with the advantages from the port's own GAE and
    # critics: 3e-3 of its length (measured 4e-5 to 8.5e-4: CG amplifies)
    assert float((ta - ja).norm() / (ja - sa).norm()) < 3e-3
    # the critics after their Adam steps of lr 1e-3: summation order gives
    # gradients ~1e-7 apart and Adam passes that on; 2e-5 absolute after 20
    # steps that move the weights by ~2e-2 (measured 7e-8)
    assert float((tc - jc).abs().max()) < 2e-5
    jadam = adam_state(jnew.critic_opt_state)
    for name in ("mu", "nu"):
        jvec = split_flat(model, full_vec(model, {
            "actor": params["actor"], "critics": getattr(jadam, name)}))[1]
        tvec = getattr(tnew.critic_opt_state, name)
        np.testing.assert_allclose(n(tvec), n(jvec), rtol=1e-3,
                                   atol=1e-5 * float(jvec.abs().max()),
                                   err_msg=name)
    for name in ("error_old", "error_integral", "multiplier", "cost_ema",
                 "ema_n"):
        np.testing.assert_allclose(n(getattr(tnew.lag, name)),
                                   np.asarray(getattr(jnew.lag, name)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    np.testing.assert_allclose(n(tnew.last_ep_cost),
                               np.asarray(jnew.last_ep_cost), rtol=1e-6)
    if case == "no_lagrangian":
        assert float(tm["loss/rescaling"]) == 1.0
        assert float(tnew.lag.multiplier.sum()) == 0.0
    else:
        assert float(tnew.lag.multiplier[0]) > 0.0
