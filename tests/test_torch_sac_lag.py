"""SAC-Lagrangian of the port against the JAX package: chained
``update_step``s from the same weights on the same replay buffer, with
JAX's sampled indices and normal draws injected. After every step the
actor, critics, target critics, ``log_alpha``, the Adam moments and the
metrics are compared. Cases cover auto-alpha on and off, the
reference-parity ``reference_qc`` branch, the ``qc_ucb`` penalty, two
constraints, no Lagrangian, and bf16 trunks.

Tolerances (f32): summation orders give gradients ~1e-7 apart, and
Adam's first steps move every weight by about ``lr * sign(g)``; parameters
and target critics are held to 1e-6 absolute after up to 5 steps of
lr <= 1e-3 (measured 3e-8 and 1.2e-7), ``log_alpha`` to rtol 1e-6
(measured 2e-10 absolute), Adam moments to rtol 1e-3, metrics to rel 1e-5
(measured 1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (adam_moments, assert_adam_matches,
                           assert_first_step_close, module_params,
                           module_vec, n, offpolicy_chain, state_dict)

from fsrl_torch.algos.sac_lag import SACLag
from fsrl_tpu.algos.sac_lag import SACLag as JSACLag

torch.set_num_threads(1)

D, A, B = 6, 2, 64
HIDDEN = (32, 32)

CASES = {
    "default": dict(),
    "fixed_alpha": dict(auto_alpha=False),
    "reference_qc": dict(reference_qc=True),
    "qc_ucb": dict(qc_ucb=0.5),
    "two_costs": dict(num_costs=2, cost_limit=[5.0, 3.0]),
    "no_lagrangian_n3": dict(use_lagrangian=False, n_step=3),
    "bf16": dict(),
}


def run_chain(case: str, n_steps: int):
    """``n_steps`` chained updates of both sides (see
    ``_torch_parity.offpolicy_chain``)."""
    kw = dict(hidden_sizes=HIDDEN, batch_size=B)
    kw.update(CASES[case])
    bf16 = case == "bf16"
    jalgo = JSACLag(D, A, compute_dtype=jnp.bfloat16 if bf16 else None, **kw)
    talgo = SACLag(D, A, compute_dtype=torch.bfloat16 if bf16 else None,
                   device="cpu", **kw)
    return offpolicy_chain(jalgo, talgo, "sac_lag", n_steps,
                           M=kw.get("num_costs", 1), batch_size=B)


def assert_state_matches(jstate, tstate, p_atol, mom_rtol):
    model = tstate.params
    for part in ("actor", "critics"):
        mod = getattr(model, part)
        want = module_vec(mod, jstate.params[part], part)
        assert float((module_params(mod) - want).abs().max()) < p_atol, part
        opt = "actor_opt_state" if part == "actor" else "critic_opt_state"
        assert_adam_matches(getattr(tstate, opt), getattr(jstate, opt), mod,
                            part, mom_rtol)
    want = module_vec(tstate.target_critic_params,
                      jstate.target_critic_params, "critics")
    assert float((tstate.target_critic_params.flat - want).abs().max()) \
        < p_atol
    np.testing.assert_allclose(float(tstate.log_alpha),
                               float(jstate.log_alpha), rtol=1e-6, atol=1e-8)
    count, mu, nu = adam_moments(jstate.alpha_opt_state)
    assert int(tstate.alpha_opt_state.count) == count
    np.testing.assert_allclose(n(tstate.alpha_opt_state.mu), np.asarray(mu),
                               rtol=mom_rtol, atol=1e-8)


@pytest.mark.parametrize("case", [c for c in CASES if c != "bf16"])
def test_chained_update_steps_match_jax(case):
    n_steps = 5 if case == "default" else 2
    for jstate, jm, tstate, tm in run_chain(case, n_steps):
        assert set(tm) == set(jm)
        for k in jm:
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5,
                                                 abs=1e-6), k
        assert_state_matches(jstate, tstate, p_atol=1e-6, mom_rtol=1e-3)
    assert int(tstate.gradient_steps) == int(jstate.gradient_steps) == n_steps
    assert int(tstate.update_count) == n_steps
    if case == "fixed_alpha":
        assert float(tstate.log_alpha) == pytest.approx(np.log(0.005))
        assert float(tm["loss/alpha_loss"]) == 0.0
    else:
        assert float(tstate.log_alpha) != 0.0


def test_bf16_update_step_matches_jax():
    """bf16 trunks, one step: metrics to 2e-2; parameters within two Adam
    steps of lr everywhere and within one for 99% of the entries (Adam's
    first step is ``lr * sign(g)``, and bf16 rounding flips the sign of
    a few gradient entries near 0)."""
    (jstate, jm, tstate, tm), = run_chain("bf16", 1)
    assert set(tm) == set(jm)
    for k in jm:
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=2e-2,
                                             abs=1e-3), k
    for part, lr in (("actor", 5e-4), ("critics", 1e-3)):
        mod = getattr(tstate.params, part)
        assert_first_step_close(module_params(mod),
                                module_vec(mod, jstate.params[part], part),
                                lr)


def test_update_lagrangian_matches_jax():
    """The PID step once per collect, filtered and exact, and held when no
    episode finished."""
    for pid_filter in (True, False):
        jalgo = JSACLag(D, A, hidden_sizes=HIDDEN, pid_filter=pid_filter)
        talgo = SACLag(D, A, hidden_sizes=HIDDEN, pid_filter=pid_filter,
                       device="cpu")
        js = jax.jit(jalgo.init)(jax.random.PRNGKey(0))
        ts = talgo.init()
        step = jax.jit(jalgo.update_lagrangian)
        for cost, n_ep in ((30.0, 3), (4.0, 0), (12.0, 1)):
            js = step(js, jnp.asarray([cost]), jnp.asarray(n_ep))
            ts = talgo.update_lagrangian(ts, torch.tensor([cost]),
                                         torch.tensor(n_ep))
            for f in ("error_old", "error_integral", "multiplier",
                      "cost_ema", "ema_n"):
                np.testing.assert_allclose(
                    n(getattr(ts.lag, f)), np.asarray(getattr(js.lag, f)),
                    rtol=1e-6, err_msg=f)
            np.testing.assert_allclose(n(ts.last_ep_cost),
                                       np.asarray(js.last_ep_cost),
                                       rtol=1e-6)


def test_act_fns_match_jax():
    """Acting: the tanh-squashed sample and its log-prob with the same
    noise; evaluation is stochastic by default."""
    jalgo = JSACLag(D, A, hidden_sizes=HIDDEN)
    talgo = SACLag(D, A, hidden_sizes=HIDDEN, device="cpu")
    params = jax.jit(jalgo.init)(jax.random.PRNGKey(1)).params
    state = talgo.init(state_dict=state_dict(params))
    obs = np.random.default_rng(0).normal(size=(16, D)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ja, jl = jalgo.act_fn(params, jnp.asarray(obs), key)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (16, A))))
    ta, tl = talgo._dist(state.params.actor,
                         torch.from_numpy(obs)).sample_and_log_prob(
        noise=noise)
    np.testing.assert_allclose(n(ta), np.asarray(ja), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(n(tl), np.asarray(jl), rtol=1e-5, atol=1e-5)
    g = torch.Generator().manual_seed(0)
    a1, _ = talgo.act_fn_eval(state.params, torch.from_numpy(obs), g)
    a2, _ = talgo.act_fn_eval(state.params, torch.from_numpy(obs), g)
    assert not torch.equal(a1, a2) and talgo.deterministic_eval is False


def test_sac_lag_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        SACLag(D, A)
