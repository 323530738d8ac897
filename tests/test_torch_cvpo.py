"""CVPO of the port against the JAX package: chained ``update_step``s from
the same weights on the same replay buffer, with JAX's sampled indices,
target-action noise and particle draws injected. Without ``post_update``
the old actor stays at its start while the actor moves, so the E-step's
particles and the M-step's KL see two different policies. After every
step the actor, critics, target critics, old actor, the E- and M-step
duals, the Adam moments and the metrics are compared. Cases cover the
double critic on and off, ``estep_iter_num`` / ``mstep_iter_num`` 1 and 2,
two constraints, a PID backstop above the E-step lambda, and bf16 trunks;
then the per-collect hooks and the qc threshold.

Tolerances (f32): parameters and targets 1e-6 absolute after up to 5
steps (measured 6e-8 and 1.8e-7), duals rtol 1e-5 (measured 7e-6 absolute
on the M-step duals after two iterations), Adam moments rtol 1e-3, metrics
rel 1e-4 (the M-step's KL of a policy that has barely moved is a
difference of nearly equal terms: measured 1.6e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (adam_moments, assert_adam_matches,
                           assert_first_step_close, module_params,
                           module_vec, n, offpolicy_buffers, offpolicy_chain,
                           state_dict)

from fsrl_torch.algos.cvpo import CVPO
from fsrl_tpu.algos.cvpo import CVPO as JCVPO

torch.set_num_threads(1)

D, A, B = 6, 2, 64
HIDDEN = (32, 32)

CASES = {
    "default": dict(),
    "single_critic": dict(double_critic=False),
    "estep2_mstep2": dict(estep_iter_num=2, mstep_iter_num=2),
    "estep1_mstep2_two_costs": dict(mstep_iter_num=2, num_costs=2,
                                    cost_limit=[5.0, 3.0]),
    "bf16": dict(),
}


def run_chain(case: str, n_steps: int):
    kw = dict(hidden_sizes=HIDDEN, batch_size=B, sample_act_num=8,
              max_episode_steps=100)
    kw.update(CASES[case])
    bf16 = case == "bf16"
    jalgo = JCVPO(D, A, compute_dtype=jnp.bfloat16 if bf16 else None, **kw)
    talgo = CVPO(D, A, compute_dtype=torch.bfloat16 if bf16 else None,
                 device="cpu", **kw)
    return offpolicy_chain(jalgo, talgo, "cvpo", n_steps,
                           M=kw.get("num_costs", 1), batch_size=B)


def assert_state_matches(jstate, tstate):
    for part, opt in (("actor", "actor_opt_state"),
                      ("critics", "critic_opt_state")):
        mod = getattr(tstate.params, part)
        want = module_vec(mod, jstate.params[part], part)
        assert float((module_params(mod) - want).abs().max()) < 1e-6, part
        assert_adam_matches(getattr(tstate, opt), getattr(jstate, opt), mod,
                            part, 1e-3)
    for name, prefix in (("target_critic_params", "critics"),
                         ("actor_old_params", "actor")):
        mod = getattr(tstate, name)
        want = module_vec(mod, getattr(jstate, name), prefix)
        assert float((mod.flat - want).abs().max()) < 1e-6, name
    for name in ("estep_dual", "mstep_dual"):
        np.testing.assert_allclose(n(getattr(tstate, name)),
                                   np.asarray(getattr(jstate, name)),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    for name in ("estep_opt_state", "mstep_opt_state"):
        count, mu, nu = adam_moments(getattr(jstate, name))
        opt = getattr(tstate, name)
        assert int(opt.count) == count, name
        np.testing.assert_allclose(n(opt.mu), np.asarray(mu), rtol=1e-3,
                                   atol=1e-9, err_msg=name)
        np.testing.assert_allclose(n(opt.nu), np.asarray(nu), rtol=1e-3,
                                   atol=1e-12, err_msg=name)


@pytest.mark.parametrize("case", [c for c in CASES if c != "bf16"])
def test_chained_update_steps_match_jax(case):
    n_steps = 5 if case == "default" else 2
    for jstate, jm, tstate, tm in run_chain(case, n_steps):
        assert set(tm) == set(jm)
        for k in jm:
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-4,
                                                 abs=1e-6), k
        assert_state_matches(jstate, tstate)
    assert int(tstate.gradient_steps) == n_steps
    # the actor moved away from the old actor
    assert not torch.equal(module_params(tstate.params.actor),
                           tstate.actor_old_params.flat)
    if case == "estep1_mstep2_two_costs":
        assert {"estep/lambda1", "estep/thres_q2"} <= set(tm)


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


def test_pid_backstop_floors_the_estep_lambda():
    """A PID multiplier above the E-step's lambda takes its place (clipped
    to the E-step cap), in the metrics and the softmax target, as in
    JAX."""
    kw = dict(hidden_sizes=HIDDEN, batch_size=B, sample_act_num=8)
    jalgo, talgo = JCVPO(D, A, **kw), CVPO(D, A, device="cpu", **kw)
    chain = offpolicy_chain(jalgo, talgo, "cvpo", 1, batch_size=B)
    (jstate, jm, tstate, tm), = chain
    # offpolicy_chain sets the multiplier to 0.5, above the first
    # E-step's lambda (0 plus one Adam step of lr 0.02)
    assert float(jm["estep/lambda0"]) == pytest.approx(0.5)
    assert float(tm["estep/lambda0"]) == pytest.approx(0.5)
    assert float(tstate.estep_dual[1]) < 0.1


def test_hooks_and_update_lagrangian_match_jax():
    jalgo = JCVPO(D, A, hidden_sizes=HIDDEN)
    talgo = CVPO(D, A, hidden_sizes=HIDDEN, device="cpu")
    js = jax.jit(jalgo.init)(jax.random.PRNGKey(0))
    ts = talgo.init(state_dict=state_dict(js.params))
    assert float(ts.estep_dual[0]) == 1.0 and float(ts.estep_dual[1]) == 0.0
    step = jax.jit(jalgo.update_lagrangian)
    for cost, n_ep in ((30.0, 3), (4.0, 0), (12.0, 1)):
        js = step(js, jnp.asarray([cost]), jnp.asarray(n_ep))
        ts = talgo.update_lagrangian(ts, torch.tensor([cost]),
                                     torch.tensor(n_ep))
        for f in ("error_old", "error_integral", "multiplier", "cost_ema",
                  "ema_n"):
            np.testing.assert_allclose(n(getattr(ts.lag, f)),
                                       np.asarray(getattr(js.lag, f)),
                                       rtol=1e-6, err_msg=f)
    # pre_update: fresh M-step duals and Adam state
    ts.mstep_dual = torch.tensor([0.3, 0.2])
    ts.mstep_opt_state.count += 4
    ts = talgo.pre_update(ts)
    assert float(ts.mstep_dual.abs().sum()) == 0.0
    assert int(ts.mstep_opt_state.count) == 0
    # post_update: the old actor becomes the actor, as a copy
    with torch.no_grad():
        ts.params.flat[:10] += 1.0
    ts = talgo.post_update(ts)
    assert torch.equal(ts.actor_old_params.flat,
                       module_params(ts.params.actor))
    with torch.no_grad():
        ts.params.flat[:10] += 1.0
    assert not torch.equal(ts.actor_old_params.flat,
                           module_params(ts.params.actor))


def test_qc_threshold_and_runtime_cost_limit():
    kw = dict(hidden_sizes=HIDDEN, gamma=0.98, max_episode_steps=500,
              cost_limit=[10.0, 25.0], num_costs=2)
    jalgo, talgo = JCVPO(D, A, **kw), CVPO(D, A, device="cpu", **kw)
    np.testing.assert_array_equal(n(talgo.qc_thres),
                                  np.asarray(jalgo.qc_thres))
    coeff = (1 - 0.98 ** 500) / (1 - 0.98) / 500
    assert float(talgo.qc_thres[0]) == pytest.approx(10.0 * coeff)
    # a runtime limit recomputes the threshold inside the step
    jbuf_kw = dict(hidden_sizes=HIDDEN, batch_size=B, sample_act_num=4)
    talgo = CVPO(D, A, device="cpu", **jbuf_kw)
    _, _, tbuf, ts = offpolicy_buffers(D, A)
    state = talgo.init()
    _, m = talgo.update_step(state, tbuf, ts, torch.Generator().manual_seed(0),
                             cost_limit=torch.tensor([40.0]))
    assert float(m["estep/thres_q1"]) == pytest.approx(
        40.0 * talgo._qc_coeff, rel=1e-6)


def test_cvpo_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        CVPO(D, A)
