"""The port's trust-region machinery (``fsrl_torch/ops/cg.py``) against the
JAX package's: conjugate gradient, the Fisher-vector product and the
backtracking line search, on the same inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import actor_tree, actor_vec, n, state_dict
from jax.flatten_util import ravel_pytree

from fsrl_tpu.algos.trpo_lag import TRPOLag as JTRPOLag
from fsrl_tpu.ops import cg as jcg
from fsrl_torch.algos.common import apply_flat, split_flat
from fsrl_torch.algos.trpo_lag import TRPOLag
from fsrl_torch.ops import cg

torch.set_num_threads(1)


def _spd(size, seed):
    rng = np.random.RandomState(seed)
    a = rng.randn(size, size)
    return ((a @ a.T + size * np.eye(size)).astype(np.float32),
            rng.randn(size).astype(np.float32))


@pytest.mark.parametrize("n_iters", [3, 10, 25])
def test_cg_matches_jax_on_spd_system(n_iters):
    A, b = _spd(50, 2)
    x_j = jcg.conjugate_gradient(lambda v: jnp.asarray(A) @ v,
                                 jnp.asarray(b), n_iters=n_iters)
    At = torch.from_numpy(A)
    x_t = cg.conjugate_gradient(lambda v: At @ v, torch.from_numpy(b),
                                n_iters=n_iters)
    # same recurrence, f32 dot products in another order: measured 3e-6
    # relative at 25 iterations
    np.testing.assert_allclose(n(x_t), np.asarray(x_j), rtol=1e-4, atol=1e-6)
    if n_iters == 25:
        np.testing.assert_allclose(n(x_t), np.linalg.solve(A, b), rtol=1e-4,
                                   atol=1e-5)


def test_cg_iterations_after_convergence_are_no_ops():
    """On the identity CG converges in one iteration; the remaining ones are
    masked and must change nothing (no 0/0 from the vanished residual)."""
    b = torch.from_numpy(np.random.RandomState(0).randn(16).astype(np.float32))
    calls = []

    def mvp(v):
        calls.append(1)
        return v.clone()

    x1 = cg.conjugate_gradient(mvp, b, n_iters=1)
    x10 = cg.conjugate_gradient(mvp, b, n_iters=10)
    assert len(calls) == 11          # the loop bound is static
    assert torch.equal(x1, x10)
    assert torch.isfinite(x10).all()
    np.testing.assert_allclose(n(x10), n(b), rtol=1e-6)
    x_j = jcg.conjugate_gradient(lambda v: v, jnp.asarray(n(b)), n_iters=10)
    np.testing.assert_allclose(n(x10), np.asarray(x_j), rtol=1e-6)


def test_flatten_round_trip():
    tensors = {"b": torch.arange(6.0).reshape(2, 3), "a": torch.ones(4)}
    flat, unravel = cg.flatten(tensors)
    assert flat.shape == (10,)
    back = unravel(flat * 2)
    assert list(back) == ["b", "a"]
    assert torch.equal(back["b"], tensors["b"] * 2)
    assert back["a"].shape == (4,)


def test_fvp_is_hessian_vector_product():
    """Twin of ``tests/test_ops.py::test_fvp_is_hessian_vector_product``
    (H = I), and the product against an explicit Hessian of a tiny actor's
    KL."""
    p0 = torch.tensor([0.3, -0.2])
    fvp = cg.make_fvp(lambda p: 0.5 * ((p - p0) ** 2).sum(), p0, damping=0.0)
    v = torch.tensor([1.0, 2.0])
    np.testing.assert_allclose(n(fvp(v)), n(v), atol=1e-6)

    algo = TRPOLag(3, 2, hidden_sizes=(4, 4), device="cpu")
    state = algo.init(seed=0)
    model = state.params
    flat_a = split_flat(model, state.flat)[0]
    obs = torch.randn(32, 3, generator=torch.Generator().manual_seed(1))
    names = model.actor_names()
    with torch.no_grad():
        old = apply_flat(model.actor, names, flat_a, obs)
    # evaluate away from the old distribution's own parameters, where the
    # KL's gradient does not vanish
    at = flat_a + 0.05 * torch.randn(
        flat_a.shape, generator=torch.Generator().manual_seed(2))
    kl = lambda f: old.kl(apply_flat(model.actor, names, f, obs)).mean()
    H = torch.autograd.functional.hessian(kl, at)
    fvp = cg.make_fvp(kl, at, damping=0.1)
    for seed in range(3):
        v = torch.randn(at.shape,
                        generator=torch.Generator().manual_seed(seed))
        # float32 on both sides (the trunk's output is float32): measured
        # 2e-7 absolute on entries of order 1
        np.testing.assert_allclose(n(fvp(v)), n(H @ v + 0.1 * v), rtol=1e-4,
                                   atol=1e-5)


def _actor_setup(dtype=None, sigma_floor=None):
    """A JAX TRPO actor, the port's twin on bridged weights, and a batch."""
    D, A, B = 6, 2, 256
    kw = dict(hidden_sizes=(32, 32), sigma_floor=sigma_floor)
    jalgo = JTRPOLag(D, A, compute_dtype=dtype and jnp.bfloat16, **kw)
    talgo = TRPOLag(D, A, compute_dtype=dtype and torch.bfloat16,
                    device="cpu", **kw)
    jparams = jax.jit(jalgo.init)(jax.random.PRNGKey(0)).params
    tstate = talgo.init(state_dict=state_dict(jparams))
    rng = np.random.default_rng(3)
    obs = rng.normal(size=(B, D)).astype(np.float32)
    return jalgo, talgo, jparams, tstate, obs


def _jax_fvp(jalgo, jparams, obs, damping=0.1):
    """JAX's FVP of mean KL(old || new) at the actor's parameters, in
    ``ravel_pytree`` order, with the unravel function."""
    old = jalgo.actor.apply(jparams["actor"], obs)
    kl_fn = lambda p: jnp.mean(old.kl(jalgo.actor.apply(p, obs)))
    _, unravel = ravel_pytree(jparams["actor"])
    return jcg.make_fvp(kl_fn, jparams["actor"], damping), unravel


def _torch_fvp(tstate, obs, damping=0.1):
    model = tstate.params
    flat_a = split_flat(model, tstate.flat)[0]
    names = model.actor_names()
    with torch.no_grad():
        old = apply_flat(model.actor, names, flat_a, torch.from_numpy(obs))
    kl = lambda f: old.kl(apply_flat(model.actor, names, f,
                                     torch.from_numpy(obs))).mean()
    return cg.make_fvp(kl, flat_a, damping)


@pytest.mark.parametrize("dtype", [None, "bf16"], ids=["f32", "bf16"])
def test_fvp_and_cg_match_jax_on_a_real_actor(dtype):
    """Double backward here, forward-over-reverse there: the same matrix.
    Vectors cross through the weight bridge (the two flat orders differ)."""
    jalgo, talgo, jparams, tstate, obs = _actor_setup(dtype)
    model = tstate.params
    jfvp, unravel = _jax_fvp(jalgo, jparams, obs)
    tfvp = _torch_fvp(tstate, obs)
    rng = np.random.default_rng(4)
    size = split_flat(model, tstate.flat)[0].numel()
    v_t = torch.from_numpy(rng.normal(size=size).astype(np.float32))
    v_j = ravel_pytree(actor_tree(model, v_t, jparams))[0]
    hv_j = actor_vec(model, unravel(jax.jit(jfvp)(v_j)), jparams)
    hv_t = tfvp(v_t)
    cos = float(torch.dot(hv_t, hv_j) / (hv_t.norm() * hv_j.norm()))
    if dtype is None:
        # measured 2e-6 of the largest entry
        np.testing.assert_allclose(n(hv_t), n(hv_j), rtol=1e-4,
                                   atol=1e-4 * float(hv_j.abs().max()))
    else:
        # bf16 trunks, differentiated twice through the casts: the two
        # libraries round intermediate products differently; measured
        # cosine 0.9999
        assert cos > 1 - 5e-2, cos
    # CG on the real FVP
    b_t = torch.from_numpy(rng.normal(size=size).astype(np.float32))
    b_j = ravel_pytree(actor_tree(model, b_t, jparams))[0]
    x_j = actor_vec(model, unravel(jax.jit(
        lambda b: jcg.conjugate_gradient(jfvp, b, 10))(b_j)), jparams)
    x_t = cg.conjugate_gradient(tfvp, b_t, 10)
    cos = float(torch.dot(x_t, x_j) / (x_t.norm() * x_j.norm()))
    if dtype is None:
        # ten unconverged iterations on the damped Fisher matrix amplify
        # the 1e-6 of each product: the solution as a whole is held to 1e-4
        # of its norm (measured 7e-6 to 4e-5), single entries to 1e-3 of
        # the largest (measured 3e-4)
        assert float((x_t - x_j).norm() / x_j.norm()) < 1e-4
        np.testing.assert_allclose(n(x_t), n(x_j), rtol=1e-4,
                                   atol=1e-3 * float(x_j.abs().max()))
    else:
        assert cos > 1 - 5e-2, cos


@pytest.mark.parametrize("threshold,expect", [(0.3, 6), (2.0, 0), (1e-9, None)],
                         ids=["seventh", "first", "none"])
def test_backtracking_line_search_matches_jax(threshold, expect):
    """First accepted candidate, and no step when none is accepted."""
    rng = np.random.RandomState(5)
    p = rng.randn(12).astype(np.float32)
    step = rng.randn(12).astype(np.float32)
    thr = threshold * float(np.linalg.norm(step))
    # accept when the candidate moved less than thr from the start
    j_out = jcg.backtracking_line_search(
        lambda c: jnp.linalg.norm(c - p), lambda m, frac: m < thr,
        jnp.asarray(p), jnp.asarray(step), 10, 0.8)
    pt = torch.from_numpy(p)
    t_out = cg.backtracking_line_search(
        lambda c: torch.linalg.norm(c - pt), lambda m, frac: m < thr,
        pt, torch.from_numpy(step), 10, 0.8)
    np.testing.assert_allclose(n(t_out[0]), np.asarray(j_out[0]), rtol=1e-6)
    assert bool(t_out[1]) == bool(j_out[1]) == (expect is not None)
    want = 0.0 if expect is None else 0.8 ** expect
    assert float(t_out[2]) == pytest.approx(float(j_out[2]), rel=1e-6)
    assert float(t_out[2]) == pytest.approx(want, rel=1e-5)
    if expect is None:
        assert torch.equal(t_out[0], pt)
