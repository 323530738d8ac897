"""The flax → PyTorch weight bridge, and the port's nets against flax
``apply`` on bridged weights."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import n, state_dict

from fsrl_tpu.algos.ppo_lag import PPOLag as JPPOLag
from fsrl_tpu.nets.mlp import fused_pi_v_apply as j_fused
from fsrl_torch.algos.ppo_lag import PPOLag
from fsrl_torch.utils.params import to_jax_params

torch.set_num_threads(1)

D, A = 9, 2


@functools.lru_cache(maxsize=None)
def _pair(K: int, bf16: bool, hidden=(128, 128)):
    jalgo = JPPOLag(D, A, num_costs=K - 1, hidden_sizes=hidden,
                    compute_dtype=jnp.bfloat16 if bf16 else None)
    params = jax.jit(jalgo.init)(jax.random.PRNGKey(K)).params
    talgo = PPOLag(D, A, num_costs=K - 1, hidden_sizes=hidden,
                   compute_dtype=torch.bfloat16 if bf16 else None,
                   device="cpu")
    state = talgo.init(state_dict=state_dict(params))
    return jalgo, params, talgo, state


def test_bridge_round_trip_is_exact():
    _, params, _, state = _pair(3, False)
    back = to_jax_params(state.params.state_dict())
    ja, jb = jax.tree.leaves(jax.device_get(params)), jax.tree.leaves(back)
    assert jax.tree.structure(jax.device_get(params)) == \
        jax.tree.structure(back)
    for a, b in zip(ja, jb):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_flat_vector_views_the_module():
    """The optimizer's flat vector and the module share storage."""
    _, params, talgo, _ = _pair(2, False)
    state = talgo.init(state_dict=state_dict(params))
    w = state.params.actor.mu.bias
    state.flat.zero_()
    assert float(w.detach().abs().sum()) == 0.0


# f32: same products, other summation order in the matmuls (~1e-6).
# bf16: both round inputs, weights and each layer's output to bf16 (8 bits
# of mantissa); rounding of a value next to a bf16 tie can differ by one
# bf16 step between XLA and PyTorch, so 2e-2.
@pytest.mark.parametrize("bf16,tol", [(False, 1e-5), (True, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("K", [2, 3])
def test_actor_and_critics_match_flax(K, bf16, tol):
    jalgo, params, _, state = _pair(K, bf16)
    obs = np.random.default_rng(K).normal(size=(64, D)).astype(np.float32)
    jd = jalgo.actor.apply(params["actor"], jnp.asarray(obs))
    jv = jalgo.critics.apply(params["critics"], jnp.asarray(obs))
    with torch.no_grad():
        td = state.params.actor(torch.from_numpy(obs))
        tv = state.params.critics(torch.from_numpy(obs))
    atol = tol if bf16 else 1e-6
    np.testing.assert_allclose(n(td.mean), np.asarray(jd.mean), rtol=tol,
                               atol=atol)
    np.testing.assert_allclose(n(td.std), np.asarray(jd.std), rtol=1e-6)
    np.testing.assert_allclose(n(tv), np.asarray(jv), rtol=tol,
                               atol=max(atol, tol * float(np.abs(jv).max())))
    assert tv.shape == (64, K)


@pytest.mark.parametrize("bf16,tol", [(False, 1e-5), (True, 2e-2)],
                         ids=["f32", "bf16"])
def test_fused_pi_v_matches_flax(bf16, tol):
    jalgo, params, _, state = _pair(2, bf16)
    obs = np.random.default_rng(5).normal(size=(32, D)).astype(np.float32)
    jd, jv = j_fused(params, jnp.asarray(obs), act_dim=A, num_critics=2,
                     compute_dtype=jnp.bfloat16 if bf16 else None)
    with torch.no_grad():
        td, tv = state.params(torch.from_numpy(obs))
    assert state.params.fused
    np.testing.assert_allclose(n(td.mean), np.asarray(jd.mean), rtol=tol,
                               atol=tol if bf16 else 1e-6)
    np.testing.assert_allclose(n(tv), np.asarray(jv), rtol=tol,
                               atol=tol * float(np.abs(jv).max()))


def test_log_prob_entropy_kl_match():
    from fsrl_tpu.nets.distributions import DiagGaussian as JG
    from fsrl_torch.nets.distributions import DiagGaussian as TG
    rng = np.random.default_rng(0)
    m1, m2, x = (rng.normal(size=(16, 3)).astype(np.float32)
                 for _ in range(3))
    s1, s2 = (np.exp(rng.normal(size=(16, 3))).astype(np.float32)
              for _ in range(2))
    j1, j2 = JG(jnp.asarray(m1), jnp.asarray(s1)), JG(jnp.asarray(m2),
                                                      jnp.asarray(s2))
    t1, t2 = (TG(torch.from_numpy(m1), torch.from_numpy(s1)),
              TG(torch.from_numpy(m2), torch.from_numpy(s2)))
    for a, b in ((j1.log_prob(jnp.asarray(x)), t1.log_prob(
            torch.from_numpy(x))), (j1.entropy(), t1.entropy()),
            (j1.kl(j2), t1.kl(t2))):
        np.testing.assert_allclose(n(b), np.asarray(a), rtol=1e-5, atol=1e-5)
