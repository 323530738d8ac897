"""The error of K2's generic f32 form by design, before the card sees it:
every trunk and weight-gradient product (z1, z2, g_h2 W2, g_h2^T h1,
g_h1^T x) taken as three TF32 products of split operands
(``tf32x3_matmul``, the mirror of ``csrc/mma_tf32.cuh``), held to the
plain float32 version and to the JAX package's Pallas kernel in interpret
mode within 1e-5 of each gradient tensor's largest entry, on rows drawn
clear of the ReLU kinks (``redraw_near_kinks``; at a kink any two float32
computations may take different sides of the ReLU)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import state_dict

from fsrl_tpu.algos.ppo_lag import PPOLag as JPPOLag
from fsrl_tpu.ops.fused_ppo_grad import ppo_grad_minibatch as j_grad
from fsrl_torch.algos.ppo_lag import PPOLag
from fsrl_torch.ops.fused_ppo_grad import (kernel_form, policy_logp,
                                           ppo_grad_plain, redraw_near_kinks,
                                           tf32_split, tf32x3_matmul)
from fsrl_torch.utils.params import to_jax_params

torch.set_num_threads(1)

TOL = 1e-5
# (D, H1, H2, A, K, B): the width phases' hidden (64, 64) at 512 rows, and
# uneven widths with more than 32 actions
SHAPES = {"h64": (9, 64, 64, 2, 2, 512), "h32x48_A40": (8, 32, 48, 40, 2, 256)}


@functools.lru_cache(maxsize=None)
def _case(D, H1, H2, A, K, B, seed=0):
    """JAX's init at hidden (H1, H2), rows from a numpy seed drawn again
    where a pre-activation lies near a kink, half the rows with ratio == 1
    in the plain f32 version."""
    kw = dict(cost_limit=[10.0] * (K - 1), num_costs=K - 1,
              hidden_sizes=(H1, H2))
    params = jax.jit(JPPOLag(D, A, **kw).init)(
        jax.random.PRNGKey(seed)).params
    algo = PPOLag(D, A, device="cpu", **kw)
    state = algo.init(state_dict=state_dict(params))
    layout = algo.grad_layout
    rng = np.random.default_rng(seed)
    f32 = lambda x: torch.tensor(np.asarray(x, dtype=np.float32))
    obs = redraw_near_kinks(state.flat, layout, f32(rng.normal(size=(B, D))),
                            lambda n: f32(rng.normal(size=(n, D))))
    act = f32(np.clip(0.5 * rng.normal(size=(B, A)), -0.99, 0.99))
    logp = policy_logp(state.flat, layout, obs, act)
    logp_old = logp + f32(np.where(np.arange(B) % 2 == 0, 0.0,
                                   0.1 * rng.normal(size=B)))
    adv_raw = rng.normal(size=(B, K))
    adv = f32((adv_raw - adv_raw.mean(0)) / (adv_raw.std(0) + 1e-8))
    ret = f32(rng.normal(size=(B, K)))
    lam = torch.linspace(0.5, 2.0, K - 1)
    resc = 1.0 / (lam.sum() + 1.0)
    return params, state.flat, layout, (obs, act, logp_old, adv, ret, lam,
                                        resc)


def _tensor_errs(layout, g, ref):
    return {name: float((v - r).abs().max()) / float(r.abs().max())
            for (name, v), r in zip(layout.views(g).items(),
                                    layout.views(ref).values())}


def test_tf32x3_matmul_error():
    """Three TF32 products of the split operands are within a few 2^-22 of
    each product's terms, where one TF32 product is off by up to 2^-10."""
    rng = np.random.default_rng(3)
    a = torch.tensor(rng.normal(size=(64, 256)), dtype=torch.float32)
    b = torch.tensor(rng.normal(size=(256, 48)), dtype=torch.float32)
    exact = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    err3 = ((tf32x3_matmul(a, b).double() - exact).abs() / scale).max()
    err1 = ((tf32_split(a)[0] @ tf32_split(b)[0]).double() - exact).abs()
    assert float(err3) < 2e-6
    assert float((err1 / scale).max()) > 100 * float(err3)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_tf32x3_plain_matches_plain_f32(shape):
    """The design's products against the plain float32 version: each
    gradient tensor within 1e-5 of its largest entry, the aux row within
    1e-5 relative (|ref| + 1)."""
    _, flat, layout, args = _case(*SHAPES[shape])
    assert kernel_form(layout) == "any"
    kw = dict(eps_clip=0.2, vf_coef=0.25, bf16=False)
    g3, a3 = ppo_grad_plain(flat, layout, *args, mm=tf32x3_matmul, **kw)
    gp, ap = ppo_grad_plain(flat, layout, *args, **kw)
    errs = _tensor_errs(layout, g3, gp)
    assert max(errs.values()) <= TOL, errs
    assert float(((a3 - ap).abs() / (ap.abs() + 1.0)).max()) <= TOL


@pytest.mark.parametrize("shape", list(SHAPES))
def test_tf32x3_plain_matches_pallas_f32(shape):
    """The design's products against the JAX package's Pallas kernel in
    float32 (interpret mode), at the same tolerance."""
    params, flat, layout, args = _case(*SHAPES[shape])
    kw = dict(eps_clip=0.2, vf_coef=0.25)
    g3, _ = ppo_grad_plain(flat, layout, *args, mm=tf32x3_matmul, bf16=False,
                           **kw)
    j = lambda x: jnp.asarray(x.numpy())
    _, _, jg = j_grad(params, *(j(x) for x in args[:5]), j(args[5]),
                      jnp.float32(float(args[6])), interpret=True,
                      compute_dtype=None, **kw)
    jg = jax.device_get(jg)
    ref = to_jax_params(dict(layout.views(g3)))
    errs = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jg)[0]:
        mine = functools.reduce(lambda d, k: d[k.key], path, ref)
        errs[jax.tree_util.keystr(path)] = float(
            np.abs(np.asarray(mine) - np.asarray(leaf)).max()
            / np.abs(np.asarray(leaf)).max())
    assert max(errs.values()) <= TOL, errs
