"""DDPG-Lagrangian of the port against the JAX package: chained
``update_step``s from the same weights on the same replay buffer, with
JAX's sampled indices injected (the step draws nothing else). After every
step the actor, critics, both target networks, the Adam moments and the
metrics are compared; cases cover two constraints, no Lagrangian, no
rescaling with a 1-step target, and bf16 trunks. Acting stores the noised
action before its clip and reports zero log-prob.

Tolerances (f32): parameters and targets 1e-6 absolute after up to 5
steps (measured 3e-8, targets 1.8e-7), Adam moments rtol 1e-3, metrics
rel 1e-5 (measured 5e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (assert_adam_matches, assert_first_step_close,
                           module_params, module_vec, n, offpolicy_chain,
                           state_dict)

from fsrl_torch.algos.ddpg_lag import DDPGLag
from fsrl_tpu.algos.ddpg_lag import DDPGLag as JDDPGLag

torch.set_num_threads(1)

D, A, B = 6, 2, 64
HIDDEN = (32, 32)

CASES = {
    "default": dict(),
    "two_costs": dict(num_costs=2, cost_limit=[5.0, 3.0]),
    "no_lagrangian": dict(use_lagrangian=False),
    "no_rescaling_n1": dict(rescaling=False, n_step=1),
    "bf16": dict(),
}


def run_chain(case: str, n_steps: int):
    kw = dict(hidden_sizes=HIDDEN, batch_size=B)
    kw.update(CASES[case])
    bf16 = case == "bf16"
    jalgo = JDDPGLag(D, A, compute_dtype=jnp.bfloat16 if bf16 else None, **kw)
    talgo = DDPGLag(D, A, compute_dtype=torch.bfloat16 if bf16 else None,
                    device="cpu", **kw)
    return offpolicy_chain(jalgo, talgo, "ddpg_lag", n_steps,
                           M=kw.get("num_costs", 1), batch_size=B)


@pytest.mark.parametrize("case", [c for c in CASES if c != "bf16"])
def test_chained_update_steps_match_jax(case):
    n_steps = 5 if case == "default" else 2
    for jstate, jm, tstate, tm in run_chain(case, n_steps):
        assert set(tm) == set(jm)
        for k in jm:
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5,
                                                 abs=1e-6), k
        for part, opt in (("actor", "actor_opt_state"),
                          ("critics", "critic_opt_state")):
            mod = getattr(tstate.params, part)
            want = module_vec(mod, jstate.params[part], part)
            assert float((module_params(mod) - want).abs().max()) < 1e-6
            tmod = getattr(tstate.target_params, part)
            want = module_vec(tmod, jstate.target_params[part], part)
            assert float((module_params(tmod) - want).abs().max()) < 1e-6
            assert_adam_matches(getattr(tstate, opt), getattr(jstate, opt),
                                mod, part, 1e-3)
    assert int(tstate.gradient_steps) == n_steps
    if case == "no_lagrangian":
        assert float(tm["loss/rescaling"]) == 1.0
    if case == "two_costs":
        assert {"loss/lagrangian", "loss/lagrangian_1"} <= set(tm)


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
    for part, lr in (("actor", 1e-4), ("critics", 1e-3)):
        mod = getattr(tstate.params, part)
        assert_first_step_close(module_params(mod),
                                module_vec(mod, jstate.params[part], part),
                                lr)


def test_act_fn_adds_noise_before_the_clip():
    jalgo = JDDPGLag(D, A, hidden_sizes=HIDDEN, exploration_noise=5.0)
    talgo = DDPGLag(D, A, hidden_sizes=HIDDEN, exploration_noise=5.0,
                    device="cpu")
    params = jax.jit(jalgo.init)(jax.random.PRNGKey(1)).params
    state = talgo.init(state_dict=state_dict(params))
    obs = torch.from_numpy(np.random.default_rng(0).normal(
        size=(256, D)).astype(np.float32))
    det, logp0 = talgo.act_fn_eval(state.params, obs, None)
    np.testing.assert_allclose(
        n(det), np.asarray(jalgo.act_fn_eval(params, jnp.asarray(n(obs)),
                                             None)[0]), rtol=1e-5, atol=1e-6)
    act, logp = talgo.act_fn(state.params, obs,
                             torch.Generator().manual_seed(0))
    assert float(act.abs().max()) > 1.0           # stored unclipped
    assert float(logp.abs().max()) == 0.0 and logp.shape == (256,)
    noise = (act - det) / 5.0
    assert abs(float(noise.std()) - 1.0) < 0.1
    assert float(logp0.abs().max()) == 0.0


def test_ddpg_lag_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        DDPGLag(D, A)
