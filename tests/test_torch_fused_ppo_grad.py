"""Kernel K2's plain version (the hand-derived PPO-Lag minibatch gradient)
against the JAX package's Pallas kernel in interpret mode, on bridged
weights, with tie rows (ratio == 1 exactly, as on every epoch's first grad
step)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import n, state_dict, t

from fsrl_tpu.algos.ppo_lag import PPOLag as JPPOLag
from fsrl_tpu.ops.fused_ppo_grad import ppo_grad_minibatch as j_grad
from fsrl_torch.algos.common import OnPolicyBatch, normalize_adv
from fsrl_torch.algos.ppo_lag import PPOLag
from fsrl_torch.ops import kernels
from fsrl_torch.ops.fused_ppo_grad import (GradLayout, _launch,
                                           ppo_grad_minibatch, ppo_grad_rows)
from fsrl_torch.utils.params import to_jax_params

torch.set_num_threads(1)

D, A = 8, 2


@functools.lru_cache(maxsize=None)
def _setup(K: int, B: int = 384):
    jalgo = JPPOLag(D, A, cost_limit=[10.0] * (K - 1), num_costs=K - 1)
    params = jax.jit(jalgo.init)(jax.random.PRNGKey(0)).params
    ks = jax.random.split(jax.random.PRNGKey(1), 6)
    obs = jax.random.normal(ks[0], (B, D))
    act = jnp.clip(jax.random.normal(ks[1], (B, A)) * 0.5, -0.99, 0.99)
    logp_old = jalgo.actor.apply(params["actor"], obs).log_prob(act)
    # half the rows have ratio == 1 exactly
    logp_old = logp_old + jnp.where(jnp.arange(B) % 2 == 0, 0.0,
                                    jax.random.normal(ks[2], (B,)) * 0.1)
    adv_raw = jax.random.normal(ks[3], (B, K))
    adv = (adv_raw - adv_raw.mean(0)) / (adv_raw.std(0) + 1e-8)
    ret = jax.random.normal(ks[4], (B, K))
    talgo = PPOLag(D, A, cost_limit=[10.0] * (K - 1), num_costs=K - 1,
                   device="cpu")
    state = talgo.init(state_dict=state_dict(params))
    return params, (obs, act, logp_old, adv, ret), talgo, state


# B = 384 runs the Pallas grid over 3 chunks of 128 rows (its accumulation)
@pytest.mark.parametrize("K", [2, 3])
def test_plain_grad_matches_pallas_interpret(K):
    params, data, talgo, state = _setup(K)
    lam = jnp.linspace(0.5, 2.0, K - 1)
    resc = 1.0 / (jnp.sum(lam) + 1.0)
    jl, jaux, jg = j_grad(params, *data, lam, resc, eps_clip=0.2,
                          vf_coef=0.25, interpret=True)
    tl, taux, tg = ppo_grad_minibatch(
        state.flat, talgo.grad_layout, *(t(x) for x in data), t(lam),
        torch.tensor(float(resc)),
        eps_clip=0.2, vf_coef=0.25)
    # tolerances of tests/test_fused_ppo_grad.py: loss rel 1e-6, grads
    # rtol 1e-4 / atol 1e-6 (f32 sums in another order)
    assert float(tl) == pytest.approx(float(jl), rel=1e-6)
    tg_tree = to_jax_params({k: v for k, v in
                             talgo.grad_layout.views(tg).items()})
    assert jax.tree.structure(tg_tree) == \
        jax.tree.structure(jax.device_get(jg))
    for a, b in zip(jax.tree.leaves(jax.device_get(jg)),
                    jax.tree.leaves(tg_tree)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-4, atol=1e-6)
    for k in ("loss_actor_rew", "loss_actor_total", "loss_vf_total", "kl",
              "entropy"):
        assert float(taux[k]) == pytest.approx(float(jaux[k]), rel=1e-5,
                                               abs=1e-6), k


def test_plain_grad_matches_port_autograd():
    """On the same minibatch, the port's autograd path (used outside the
    kernel's envelope) and the hand-derived gradient agree."""
    _, data, talgo, state = _setup(2)
    obs, act, logp_old, adv, ret = (t(x) for x in data)
    lam = torch.tensor([1.7])
    resc = 1.0 / (lam.sum() + 1.0)
    _, _, g_plain = ppo_grad_minibatch(state.flat, talgo.grad_layout, obs,
                                       act, logp_old, normalize_adv(adv), ret,
                                       lam, resc)
    mb = OnPolicyBatch(obs, act, logp_old, adv, ret, torch.zeros_like(ret))
    _, _, g_auto = talgo._autograd_step(state, mb, lam, resc)
    np.testing.assert_allclose(n(g_auto), n(g_plain), rtol=1e-4, atol=1e-6)


def test_cpu_tensors_take_the_plain_version():
    _, data, talgo, state = _setup(2)
    args = [t(x) for x in data]
    before = sum(kernels.LAUNCHES.values())
    g, aux = ppo_grad_rows(state.flat, talgo.grad_layout, *args,
                           torch.tensor([1.0]), torch.tensor(0.5))
    assert sum(kernels.LAUNCHES.values()) == before
    assert g.shape == (talgo.grad_layout.size,) and aux.shape == (8,)
    # the launcher itself takes CUDA tensors only, and never falls back
    with pytest.raises(ValueError):
        _launch(state.flat, talgo.grad_layout, *args, torch.tensor([1.0]),
                torch.tensor(0.5), eps_clip=0.2, vf_coef=0.25, bf16=False)


def test_kernel_envelope():
    assert GradLayout(D=9, H=128, A=2, K=2).kernel_fits()
    assert not GradLayout(D=9, H=64, A=2, K=2).kernel_fits()
    assert not GradLayout(D=40, H=128, A=2, K=2).kernel_fits()
    assert PPOLag(9, 2, device="cpu").use_grad_kernel
    assert not PPOLag(9, 2, dual_clip=3.0, device="cpu").use_grad_kernel
    assert not PPOLag(9, 2, value_clip=True, device="cpu").use_grad_kernel
    assert not PPOLag(9, 2, hidden_sizes=(64, 64),
                      device="cpu").use_grad_kernel
