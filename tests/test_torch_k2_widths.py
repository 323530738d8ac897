"""Kernel K2 at every shape of the Pallas kernel's gate: hidden widths other
than (128, 128), uneven widths, and more than 32 actions. The port's plain
gradient against the JAX package's Pallas kernel in interpret mode, the
port's gate against JAX's ``_pallas_ok``, the form each shape takes, one
PPO-Lag update against JAX's, and the stacked actor-critic forward at
uneven widths."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import n, rollout_transitions, state_dict, t, transition
from test_torch_ppo_lag import _jax_perms

from fsrl_tpu.algos.ppo_lag import PPOLag as JPPOLag
from fsrl_tpu.ops.fused_ppo_grad import ppo_grad_minibatch as j_grad
from fsrl_torch.algos.ppo_lag import PPOLag
from fsrl_torch.nets.mlp import fused_pi_v_apply
from fsrl_torch.ops.fused_ppo_grad import (KERNEL_A_MAX, GradLayout,
                                           kernel_form, launch_name,
                                           ppo_grad_minibatch)
from fsrl_torch.utils.params import to_jax_params

torch.set_num_threads(1)

# (D, H1, H2, A, K): even widths other than 128, uneven widths, and more
# than 32 actions. The Pallas kernel does not take K 1 (its ``adv[:, 1:]``
# slice of a one-column block is out of bounds in interpret mode), so
# hidden (16, 16) with A 1 and K 1 is held against the port's autograd
# step here and against JAX's update below.
WIDTHS = {"h64": (9, 64, 64, 2, 2), "h64x32_K3": (9, 64, 32, 3, 3),
          "h32x48_A40": (8, 32, 48, 40, 2)}


@functools.lru_cache(maxsize=None)
def _case(D, H1, H2, A, K, B=256, seed=0):
    """Weights from the JAX init at hidden (H1, H2), inputs from a numpy
    seed; half the rows with ratio == 1 in f32 (the tie case of every
    epoch's first grad step)."""
    kw = dict(cost_limit=[10.0] * (K - 1), num_costs=K - 1,
              hidden_sizes=(H1, H2))
    jalgo = JPPOLag(D, A, **kw)
    params = jax.jit(jalgo.init)(jax.random.PRNGKey(seed)).params
    rng = np.random.default_rng(seed)
    f32 = lambda x: jnp.asarray(x.astype(np.float32))
    obs = f32(rng.normal(size=(B, D)))
    act = f32(np.clip(0.5 * rng.normal(size=(B, A)), -0.99, 0.99))
    logp_old = jalgo.actor.apply(params["actor"], obs).log_prob(act)
    logp_old = logp_old + f32(np.where(np.arange(B) % 2 == 0, 0.0,
                                       0.1 * rng.normal(size=B)))
    adv_raw = rng.normal(size=(B, K))
    adv = f32((adv_raw - adv_raw.mean(0)) / (adv_raw.std(0) + 1e-8))
    ret = f32(rng.normal(size=(B, K)))
    talgo = PPOLag(D, A, device="cpu", **kw)
    state = talgo.init(state_dict=state_dict(params))
    return params, (obs, act, logp_old, adv, ret), talgo, state


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(WIDTHS))
def test_plain_grad_matches_pallas_interpret_at_widths(case, bf16):
    D, H1, H2, A, K = WIDTHS[case]
    params, data, talgo, state = _case(D, H1, H2, A, K)
    layout = talgo.grad_layout
    assert (layout.H, layout.H2) == (H1, H2) and talgo.use_grad_kernel
    assert kernel_form(layout) == "any"
    lam = jnp.linspace(0.5, 2.0, K - 1)
    resc = 1.0 / (jnp.sum(lam) + 1.0)
    jl, jaux, jg = j_grad(params, *data, lam, resc, eps_clip=0.2,
                          vf_coef=0.25, interpret=True,
                          compute_dtype=jnp.bfloat16 if bf16 else None)
    tl, taux, tg = ppo_grad_minibatch(
        state.flat, layout, *(t(x) for x in data), t(lam),
        torch.tensor(float(resc)), eps_clip=0.2, vf_coef=0.25, bf16=bf16)
    tg_tree = to_jax_params(dict(layout.views(tg)))
    jg = jax.device_get(jg)
    assert jax.tree.structure(tg_tree) == jax.tree.structure(jg)
    for a, b in zip(jax.tree.leaves(jg), jax.tree.leaves(tg_tree)):
        a = np.asarray(a)
        assert b.shape == a.shape
        if bf16:
            # an operand may round to the neighbouring bf16 value where its
            # f32 sum came out in another order: 1e-2 of the largest entry,
            # as tests/test_torch_fused_ppo_grad.py's bf16 tests
            assert np.abs(b - a).max() <= 1e-2 * np.abs(a).max() + 1e-9
        else:
            # f32 sums in another order (tests/test_fused_ppo_grad.py)
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-6)
    tol = 1e-2 if bf16 else 1e-5
    assert float(tl) == pytest.approx(float(jl), rel=tol, abs=1e-6)
    for k in ("loss_actor_rew", "loss_actor_total", "loss_vf_total", "kl",
              "entropy"):
        assert float(taux[k]) == pytest.approx(float(jaux[k]), rel=tol,
                                               abs=1e-6), k


def test_plain_grad_without_cost_channel_at_width_16():
    """(D, H1, H2, A, K) = (5, 16, 16, 1, 1): the plain gradient against the
    port's autograd step, at the tolerances of the K 1 test in
    tests/test_torch_fused_ppo_grad.py."""
    from fsrl_torch.algos.common import OnPolicyBatch, normalize_adv
    _, data, talgo, state = _case(5, 16, 16, 1, 1)
    assert talgo.use_grad_kernel and kernel_form(talgo.grad_layout) == "any"
    obs, act, logp_old, adv, ret = (t(x) for x in data)
    lam, resc = torch.zeros(0), torch.tensor(1.0)
    _, _, g_plain = ppo_grad_minibatch(state.flat, talgo.grad_layout, obs,
                                       act, logp_old, normalize_adv(adv), ret,
                                       lam, resc)
    mb = OnPolicyBatch(obs, act, logp_old, adv, ret, torch.zeros_like(ret))
    _, _, g_auto = talgo._autograd_step(state, mb, lam, resc)
    np.testing.assert_allclose(n(g_auto), n(g_plain), rtol=1e-4, atol=1e-6)


GATE_HIDDEN = [(64, 64), (64, 32), (128, 128), (256, 256), (32, 48),
               (128, 256), (128,), (64, 64, 64)]
GATE_ACTIONS = [1, 2, 17, 32, 33, 40, 128]


@pytest.mark.parametrize("hidden", GATE_HIDDEN,
                         ids=["x".join(map(str, h)) for h in GATE_HIDDEN])
def test_gate_equals_pallas_ok(hidden):
    """``PPOLag.use_grad_kernel`` is JAX's ``_pallas_ok`` on a grid of
    widths, actions, constraints and the recipe's switches (``dp_blocks``
    1: the port keeps K2 under data parallelism, where JAX turns it off),
    and the layout's form is the tuned one exactly at hidden (128, 128)
    with up to 32 actions."""
    D = 9
    switches = [dict(), dict(dual_clip=3.0), dict(value_clip=True),
                dict(advantage_normalization=False), dict(unbounded=True),
                dict(max_action=2.0)]
    for A in GATE_ACTIONS:
        for M in range(6):
            for sw in switches[:1] if M else switches:
                kw = dict(hidden_sizes=hidden, num_costs=M,
                          cost_limit=[10.0] * M, **sw)
                ok = JPPOLag(D, A, **kw)._pallas_ok
                talgo = PPOLag(D, A, device="cpu", **kw)
                assert talgo.use_grad_kernel == ok, (hidden, A, M, sw)
                if len(hidden) != 2:
                    continue
                layout = talgo.grad_layout
                assert layout.kernel_fits()
                assert (layout.H, layout.H2) == hidden
                tuned = hidden == (128, 128) and A <= KERNEL_A_MAX
                assert kernel_form(layout) == ("tuned" if tuned else "any")
                assert launch_name(layout, True) == (
                    "fused_ppo_grad" if tuned else "fused_ppo_grad_any")
                assert launch_name(layout, False) == (
                    "fused_ppo_grad_f32" if tuned
                    else "fused_ppo_grad_any_f32")
    # the aux row's 8 slots hold 3 + M sums: K 7 (M 6) is outside, where
    # the Pallas kernel's gate does not look and its aux row drops the
    # sixth cost term
    assert not GradLayout(D=9, H=64, A=2, K=7, H2=32).kernel_fits()
    assert not PPOLag(9, 2, hidden_sizes=hidden, num_costs=6,
                      cost_limit=[1.0] * 6, device="cpu").use_grad_kernel
    # H2 defaults to H
    assert GradLayout(D=9, H=64, A=2, K=2) == GradLayout(D=9, H=64, A=2, K=2,
                                                         H2=64)


def _transitions(jalgo, params, T, N, D, A, M, seed):
    """Random JAX transitions (M cost channels) whose old log-probs lie
    within 0.1 of the policy's, so that the ratios are near 1 at any number
    of actions."""
    tr = rollout_transitions(T, N, D, A, M, seed)
    noise = np.random.default_rng(seed + 1).normal(size=(T, N))
    logp = jalgo.actor.apply(params["actor"], tr.obs).log_prob(tr.act)
    return dataclasses.replace(
        tr, logp=logp + jnp.asarray(0.1 * noise, jnp.float32))


# (D, A, hidden, M): uneven widths; more than 32 actions at the default
# width, which only the generic form takes; no cost channel at width 16
UPDATE_WIDTHS = {"h64x32": (6, 2, (64, 32), 1), "a40": (8, 40, (128, 128), 1),
                 "h16_a1_k1": (5, 1, (16, 16), 0)}


@pytest.mark.parametrize("case", list(UPDATE_WIDTHS))
def test_update_matches_jax_at_widths(case):
    """One whole PPO-Lag update (2 epochs x 2 minibatches) through K2's
    plain version against JAX's update (``jax.grad`` of its loss), from the
    same weights, transitions and tile permutations."""
    D, A, hidden, M = UPDATE_WIDTHS[case]
    kw = dict(repeat=2, n_minibatches=2, cost_limit=[5.0] * M, num_costs=M,
              hidden_sizes=hidden)
    jalgo = JPPOLag(D, A, gae_impl="scan", **kw)
    jstate = jalgo.init(jax.random.PRNGKey(3))
    params = jstate.params
    talgo = PPOLag(D, A, device="cpu", **kw)
    assert talgo.use_grad_kernel and jalgo._pallas_ok
    assert kernel_form(talgo.grad_layout) == "any"
    tstate = talgo.init(state_dict=state_dict(params))
    T, N = 16, 32
    jtr = _transitions(jalgo, params, T, N, D, A, M, seed=4)
    ep_cost = np.full(M, 7.0, np.float32)
    rng = jax.random.PRNGKey(5)
    jnew, jm = jax.jit(jalgo.update)(jstate, jtr, jnp.asarray(ep_cost),
                                     jnp.asarray(3, jnp.int32), rng)
    tnew, tm = talgo.update(tstate, transition(jtr), t(ep_cost),
                            torch.tensor(3, dtype=torch.int32), None,
                            perms=_jax_perms(rng, T * N, 2, 2)[:2])
    assert set(tm) == set(jm)
    # the tolerances of tests/test_torch_ppo_lag.py::test_update_matches_jax
    for k in jm:
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-4,
                                             abs=1e-6), k
    assert int(tnew.gradient_steps) == int(jnew.gradient_steps) == 4
    jp = jax.tree.leaves(jax.device_get(jnew.params))
    tp = jax.tree.leaves(to_jax_params(tnew.params.state_dict()))
    assert [a.shape for a in tp] == [np.shape(b) for b in jp]
    worst = max(float(np.abs(a - np.asarray(b)).max()) for a, b in zip(tp, jp))
    assert worst < 1e-5, worst
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                for a, b in zip(jp, jax.tree.leaves(jax.device_get(params))))
    assert moved > 1e-4


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_stacked_forward_at_uneven_widths(dtype):
    """``ActorCritic.fused`` at hidden (64, 32): the stacked chain (one
    matmul over the K + 1 towers a layer) equals the separate forwards."""
    algo = PPOLag(7, 3, num_costs=2, cost_limit=[5.0, 5.0],
                  hidden_sizes=(64, 32), compute_dtype=dtype, device="cpu")
    model = algo.init(seed=0).params
    assert model.fused
    obs = torch.as_tensor(np.random.default_rng(0).normal(
        size=(50, 7)).astype(np.float32))
    dist, values = fused_pi_v_apply(model.actor, model.critics, obs)
    dist_ref, values_ref = model.actor(obs), model.critics(obs)
    assert values.shape == (50, 3)
    # the same products, summed in another order by the batched matmul
    tol = dict(rtol=1e-2, atol=1e-2) if dtype else dict(rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(values, values_ref, **tol)
    torch.testing.assert_close(dist.mean, dist_ref.mean, **tol)
    torch.testing.assert_close(dist.std, dist_ref.std)
    assert n(model(obs)[1]).shape == (50, 3)
