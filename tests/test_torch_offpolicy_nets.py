"""The port's off-policy nets and distributions against the JAX package:
``TanhGaussian`` (log-prob correction far into softplus' tail),
``gaussian_kl_decoupled``, the conditioned-sigma Gaussian actor (with a
tie at the clip bound), the deterministic actor and the Q-critic ensemble,
values and parameter gradients in f32 and bf16, and the weight bridge's
round trip for the three algorithms' parameter trees.

Tolerances: f32 values rtol 1e-5 (summation order), gradients 1e-5 of the
largest entry; bf16 values 2e-2 (an operand may round to the neighbouring
bf16 value when its f32 sum came out otherwise) and gradients 5e-2 of the
largest entry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import n, state_dict

from fsrl_torch.algos.cvpo import CVPO
from fsrl_torch.algos.ddpg_lag import DDPGLag
from fsrl_torch.algos.sac_lag import SACLag
from fsrl_torch.nets.distributions import (TanhGaussian,
                                           gaussian_kl_decoupled)
from fsrl_torch.nets.mlp import (DeterministicActor, GaussianActor,
                                 QCriticEnsemble)
from fsrl_torch.utils.params import from_jax_params, to_jax_params
from fsrl_tpu.algos.cvpo import CVPO as JCVPO
from fsrl_tpu.algos.ddpg_lag import DDPGLag as JDDPGLag
from fsrl_tpu.algos.sac_lag import SACLag as JSACLag
from fsrl_tpu.nets import distributions as jd
from fsrl_tpu.nets import mlp as jm

torch.set_num_threads(1)

D, A, H = 5, 2, (32, 32)


def _f(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def test_tanh_gaussian_matches_jax():
    rng = np.random.default_rng(0)
    B = 64
    mean, std = _f(rng, B, A, scale=3.0), np.exp(_f(rng, B, A))
    jdist = jd.TanhGaussian(jnp.asarray(mean), jnp.asarray(std))
    tdist = TanhGaussian(torch.from_numpy(mean), torch.from_numpy(std))
    # JAX's sampler and the port fed the same normal draws
    key = jax.random.PRNGKey(3)
    noise = np.array(jax.random.normal(key, (B, A)))
    ja, jl = jdist.sample_and_log_prob(key)
    act, logp = tdist.sample_and_log_prob(noise=torch.from_numpy(noise))
    np.testing.assert_allclose(n(act), np.asarray(ja), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(n(logp), np.asarray(jl), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(tdist.mode()), np.asarray(jdist.mode()),
                               rtol=1e-6)
    # pre-tanh values far into softplus' tail (|2x| up to 80), where
    # F.softplus would switch to the identity
    x = np.linspace(-40, 40, 2 * B, dtype=np.float32).reshape(B, A)
    want = jdist.log_prob_from_pre_tanh(jnp.asarray(x))
    got = tdist.log_prob_from_pre_tanh(torch.from_numpy(x))
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


def test_gaussian_kl_decoupled_matches_jax():
    rng = np.random.default_rng(1)
    args = [_f(rng, 32, A), np.exp(_f(rng, 32, A)), _f(rng, 32, A),
            np.exp(_f(rng, 32, A))]
    want = jd.gaussian_kl_decoupled(*map(jnp.asarray, args))
    got = gaussian_kl_decoupled(*map(torch.from_numpy, args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g), np.asarray(w), rtol=1e-5, atol=1e-7)


def _grads_match(tgrads: dict, jgrads, rel: float):
    """Port gradients by state-dict name against a flax gradient tree."""
    want = from_jax_params(jax.device_get(jgrads))
    assert set(tgrads) == set(want)
    for k, g in tgrads.items():
        w = want[k]
        assert float((g - w).abs().max()) <= rel * float(w.abs().max()) \
            + 1e-7, k


def _port_grads(module, prefix, loss):
    names = [k for k, _ in module.named_parameters()]
    gs = torch.autograd.grad(loss, list(module.parameters()))
    return {f"{prefix}.{k}": g for k, g in zip(names, gs)}


@pytest.mark.parametrize("unbounded,bf16", [(True, False), (False, False),
                                            (True, True)],
                         ids=["sac", "cvpo", "sac_bf16"])
def test_conditioned_sigma_actor_matches_jax(unbounded, bf16):
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (None, None)
    jact = jm.GaussianActor(act_dim=A, hidden_sizes=H, unbounded=unbounded,
                            conditioned_sigma=True, compute_dtype=jdt)
    obs = _f(np.random.default_rng(2), 48, D, scale=2.0)
    params = jax.jit(jact.init)(jax.random.PRNGKey(0), jnp.asarray(obs))
    # push a few log-sigmas past the clip bounds
    params = jax.tree.map(lambda x: x, params)
    params["params"]["Dense_1"]["bias"] = jnp.asarray([25.0, -30.0])
    tact = GaussianActor(D, A, H, unbounded=unbounded,
                         conditioned_sigma=True, compute_dtype=tdt)
    sd = from_jax_params({"actor": params})
    tact.load_state_dict({k[len("actor."):]: v for k, v in sd.items()})
    w = _f(np.random.default_rng(3), 48, A)

    def jloss(p):
        d = jact.apply(p, jnp.asarray(obs))
        return jnp.sum(d.mean * w) + jnp.sum(jnp.log(d.std) * w)

    jdist = jax.jit(jact.apply)(params, jnp.asarray(obs))
    tdist = tact(torch.from_numpy(obs))
    vrel = 2e-2 if bf16 else 1e-5
    np.testing.assert_allclose(n(tdist.mean), np.asarray(jdist.mean),
                               rtol=vrel, atol=vrel * 1e-2)
    np.testing.assert_allclose(n(tdist.std), np.asarray(jdist.std),
                               rtol=vrel)
    assert float(tdist.std.detach().max()) == pytest.approx(np.exp(2.0), rel=1e-6)
    loss = (tdist.mean * torch.from_numpy(w)).sum() \
        + (torch.log(tdist.std) * torch.from_numpy(w)).sum()
    _grads_match(_port_grads(tact, "actor", loss),
                 {"actor": jax.jit(jax.grad(jloss))(params)},
                 5e-2 if bf16 else 1e-5)


def test_sigma_clip_tie_passes_half_the_gradient():
    """A log-sigma exactly at a clip bound gets half the gradient, as
    ``jnp.clip`` (``minimum(maximum(.))``) gives; ``torch.clamp`` would
    give all of it."""
    tact = GaussianActor(D, A, H, unbounded=True, conditioned_sigma=True)
    with torch.no_grad():
        tact.sigma.weight.zero_()
        tact.sigma.bias.copy_(torch.tensor([2.0, -20.0]))
    dist = tact(torch.ones(1, D))
    (g,) = torch.autograd.grad(torch.log(dist.std).sum(), tact.sigma.bias)
    np.testing.assert_array_equal(n(g), [0.5, 0.5])
    jact = jm.GaussianActor(act_dim=A, hidden_sizes=H, unbounded=True,
                            conditioned_sigma=True)
    params = jact.init(jax.random.PRNGKey(0), jnp.ones((1, D)))
    params["params"]["Dense_1"]["kernel"] = jnp.zeros((H[-1], A))
    params["params"]["Dense_1"]["bias"] = jnp.asarray([2.0, -20.0])
    jg = jax.grad(lambda p: jnp.sum(jnp.log(jact.apply(
        p, jnp.ones((1, D))).std)))(params)
    np.testing.assert_array_equal(np.asarray(jg["params"]["Dense_1"]["bias"]),
                                  [0.5, 0.5])


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_deterministic_actor_matches_jax(bf16):
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (None, None)
    jact = jm.DeterministicActor(act_dim=A, hidden_sizes=H, max_action=2.0,
                                 compute_dtype=jdt)
    obs = _f(np.random.default_rng(4), 40, D)
    params = jax.jit(jact.init)(jax.random.PRNGKey(1), jnp.asarray(obs))
    tact = DeterministicActor(D, A, H, max_action=2.0, compute_dtype=tdt)
    sd = from_jax_params({"actor": params})
    tact.load_state_dict({k[len("actor."):]: v for k, v in sd.items()})
    w = _f(np.random.default_rng(5), 40, A)
    out = tact(torch.from_numpy(obs))
    want = jact.apply(params, jnp.asarray(obs))
    rel = 2e-2 if bf16 else 1e-5
    np.testing.assert_allclose(n(out), np.asarray(want), rtol=rel,
                               atol=rel * 1e-2)
    jg = jax.grad(lambda p: jnp.sum(jact.apply(p, jnp.asarray(obs)) * w))(
        params)
    _grads_match(_port_grads(tact, "actor", (out * torch.from_numpy(w)).sum()),
                 {"actor": jg}, 5e-2 if bf16 else 1e-5)


@pytest.mark.parametrize("M,Q,bf16", [(2, 2, False), (2, 1, False),
                                      (3, 2, False), (2, 2, True)],
                         ids=["sac", "ddpg", "two_costs", "bf16"])
def test_q_critic_ensemble_matches_jax(M, Q, bf16):
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (None, None)
    jq = jm.QCriticEnsemble(num_metrics=M, num_q=Q, hidden_sizes=H,
                            compute_dtype=jdt)
    rng = np.random.default_rng(6)
    obs, act = _f(rng, 3, 20, D), _f(rng, 3, 20, A)   # leading axes kept
    params = jax.jit(jq.init)(jax.random.PRNGKey(2), jnp.asarray(obs),
                     jnp.asarray(act))
    tq = QCriticEnsemble(D, A, M, Q, H, compute_dtype=tdt)
    sd = from_jax_params({"critics": params})
    tq.load_state_dict({k[len("critics."):]: v for k, v in sd.items()})
    to, ta = torch.from_numpy(obs), torch.from_numpy(act).requires_grad_()
    out = tq(to, ta).detach()
    want = jax.jit(jq.apply)(params, jnp.asarray(obs), jnp.asarray(act))
    assert out.shape == (3, 20, M, Q) and out.dtype == torch.float32
    rel = 2e-2 if bf16 else 1e-5
    scale = float(np.abs(np.asarray(want)).max())
    assert float((out - torch.from_numpy(np.asarray(want))).abs().max()) \
        <= rel * scale
    np.testing.assert_allclose(
        n(tq.predict(to, ta).detach()), np.asarray(want).min(-1), rtol=rel,
        atol=rel * scale)
    w = _f(rng, 3, 20, M, Q)
    jloss = lambda p, a: jnp.sum(jq.apply(p, jnp.asarray(obs), a) * w)
    jgp, jga = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params,
                                                        jnp.asarray(act))
    loss = (tq(to, ta) * torch.from_numpy(w)).sum()
    tg = _port_grads(tq, "critics", loss)
    _grads_match(tg, {"critics": jgp}, 5e-2 if bf16 else 1e-5)
    # the gradient with respect to the action (the actor losses' path)
    (ga,) = torch.autograd.grad((tq(to, ta) * torch.from_numpy(w)).sum(), ta)
    jga = np.asarray(jga)
    assert float(np.abs(n(ga) - jga).max()) <= (5e-2 if bf16 else 1e-5) * \
        float(np.abs(jga).max())


@pytest.mark.parametrize("jcls,tcls,kw", [
    (JDDPGLag, DDPGLag, {}), (JSACLag, SACLag, {}), (JCVPO, CVPO, {}),
    (JCVPO, CVPO, dict(double_critic=False, num_costs=2))],
    ids=["ddpg_lag", "sac_lag", "cvpo", "cvpo_single_q_two_costs"])
def test_bridge_roundtrip_is_exact(jcls, tcls, kw):
    """flax tree → port state dict → module → state dict → flax tree, bit
    for bit, for each algorithm's actor and critics."""
    jalgo = jcls(D, A, hidden_sizes=H, **kw)
    params = jax.device_get(jax.jit(jalgo.init)(jax.random.PRNGKey(7))
                            .params)
    talgo = tcls(D, A, hidden_sizes=H, device="cpu", **kw)
    state = talgo.init(state_dict=state_dict(params))
    sd = {k: v for k, v in state.params.state_dict().items()}
    back = to_jax_params(sd)
    flat_j = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_b)
    for path, leaf in flat_j:
        got = flat_b[path]
        assert got.shape == leaf.shape, path
        np.testing.assert_array_equal(got, np.asarray(leaf), err_msg=str(path))
    # the flat vector holds exactly these parameters
    assert state.params.flat.numel() == sum(
        np.asarray(x).size for x in jax.tree.leaves(params))
