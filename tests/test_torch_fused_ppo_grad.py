"""Kernel K2's plain version (the hand-derived PPO-Lag minibatch gradient)
against the JAX package's Pallas kernel in interpret mode, in f32 and in
bf16 compute and at the edges of the kernel's envelope, on bridged weights,
with tie rows (ratio == 1 exactly, as on every epoch's first grad step);
and the f32 kernel's error model (three TF32 products for each product)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import n, state_dict, t
from torch.overrides import TorchFunctionMode

from fsrl_tpu.algos.ppo_lag import PPOLag as JPPOLag
from fsrl_tpu.ops.fused_ppo_grad import ppo_grad_minibatch as j_grad
from fsrl_torch.algos.common import OnPolicyBatch, normalize_adv
from fsrl_torch.algos.ppo_lag import PPOLag
from fsrl_torch.ops import kernels
from fsrl_torch.ops.fused_ppo_grad import (KERNEL_A_MAX, KINK_MARGIN,
                                           GradLayout, _launch, kernel_form,
                                           policy_logp, ppo_grad_minibatch,
                                           ppo_grad_plain, ppo_grad_rows,
                                           redraw_near_kinks, relu_margin,
                                           tf32_split, tile_offset)
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
    # any hidden width, as the Pallas kernel's gate (the generic form)
    assert GradLayout(D=9, H=64, A=2, K=2).kernel_fits()
    assert kernel_form(GradLayout(D=9, H=64, A=2, K=2)) == "any"
    assert kernel_form(GradLayout(D=9, H=128, A=2, K=2)) == "tuned"
    # both kernel forms take every navigation task's observation (D <= 64)
    assert GradLayout(D=64, H=128, A=4, K=6).kernel_fits()
    # and, as the Pallas kernel's gate, any wider one: the velocity suite's
    # Ant (105, 8) and Humanoid (348, 17)
    assert GradLayout(D=65, H=128, A=2, K=2).kernel_fits()
    assert GradLayout(D=105, H=128, A=8, K=6).kernel_fits()
    assert GradLayout(D=348, H=128, A=17, K=2).kernel_fits()
    assert GradLayout(D=17, H=128, A=6, K=2).kernel_fits()
    assert GradLayout(D=64, H=128, A=8, K=6).kernel_fits()
    assert GradLayout(D=9, H=128, A=9, K=2).kernel_fits()
    # the tuned forms up to KERNEL_A_MAX actions, which the f32 kernel's
    # shared memory sets; the generic form above
    assert GradLayout(D=9, H=128, A=KERNEL_A_MAX, K=6).kernel_fits()
    assert kernel_form(GradLayout(D=9, H=128, A=KERNEL_A_MAX, K=6)) == "tuned"
    assert GradLayout(D=9, H=128, A=KERNEL_A_MAX + 1, K=2).kernel_fits()
    assert kernel_form(GradLayout(D=9, H=128, A=KERNEL_A_MAX + 1,
                                  K=2)) == "any"
    # the aux row's 8 slots: at most 5 constraints
    assert not GradLayout(D=9, H=128, A=2, K=7).kernel_fits()
    assert PPOLag(17, 6, device="cpu").use_grad_kernel
    assert PPOLag(17, 9, device="cpu").use_grad_kernel
    assert PPOLag(105, 8, device="cpu").use_grad_kernel
    assert PPOLag(348, 17, device="cpu").use_grad_kernel
    assert PPOLag(9, 2, device="cpu").use_grad_kernel
    assert not PPOLag(9, 2, dual_clip=3.0, device="cpu").use_grad_kernel
    assert not PPOLag(9, 2, value_clip=True, device="cpu").use_grad_kernel
    assert PPOLag(9, 2, hidden_sizes=(64, 64), device="cpu").use_grad_kernel
    assert not PPOLag(9, 2, num_costs=6, cost_limit=[1.0] * 6,
                      device="cpu").use_grad_kernel


def _np_case(D_, A_, K, B, seed):
    """Weights from the JAX init, inputs from a numpy seed; half the rows
    with ratio == 1 in f32."""
    jalgo = JPPOLag(D_, A_, cost_limit=[10.0] * (K - 1), num_costs=K - 1)
    params = jax.jit(jalgo.init)(jax.random.PRNGKey(seed)).params
    rng = np.random.default_rng(seed)
    f32 = lambda x: jnp.asarray(x.astype(np.float32))
    obs = f32(rng.normal(size=(B, D_)))
    act = f32(np.clip(0.5 * rng.normal(size=(B, A_)), -0.99, 0.99))
    logp_old = jalgo.actor.apply(params["actor"], obs).log_prob(act)
    logp_old = logp_old + f32(np.where(np.arange(B) % 2 == 0, 0.0,
                                       0.1 * rng.normal(size=B)))
    adv_raw = rng.normal(size=(B, K))
    adv = f32((adv_raw - adv_raw.mean(0)) / (adv_raw.std(0) + 1e-8))
    ret = f32(rng.normal(size=(B, K)))
    talgo = PPOLag(D_, A_, cost_limit=[10.0] * (K - 1), num_costs=K - 1,
                   device="cpu")
    state = talgo.init(state_dict=state_dict(params))
    return params, (obs, act, logp_old, adv, ret), talgo, state


def _assert_matches_pallas(params, data, talgo, state, K, bf16):
    lam = jnp.linspace(0.5, 2.0, K - 1)
    resc = 1.0 / (jnp.sum(lam) + 1.0)
    jl, jaux, jg = j_grad(params, *data, lam, resc, eps_clip=0.2,
                          vf_coef=0.25, interpret=True,
                          compute_dtype=jnp.bfloat16 if bf16 else None)
    tl, taux, tg = ppo_grad_minibatch(
        state.flat, talgo.grad_layout, *(t(x) for x in data), t(lam),
        torch.tensor(float(resc)), eps_clip=0.2, vf_coef=0.25, bf16=bf16)
    tg_tree = to_jax_params(dict(talgo.grad_layout.views(tg)))
    jg = jax.device_get(jg)
    assert jax.tree.structure(tg_tree) == jax.tree.structure(jg)
    # f32: sums in another order, 1e-5 of each tensor's largest entry.
    # bf16: both round the same operands to bf16 and sum in f32, but a sum
    # taken in another order can round to the neighbouring bf16 value
    # (2^-8 relative), so each tensor is held to 1e-2 of its largest entry
    tol = 1e-2 if bf16 else 1e-5
    for a, b in zip(jax.tree.leaves(jg), jax.tree.leaves(tg_tree)):
        a = np.asarray(a)
        assert np.abs(b - a).max() <= tol * np.abs(a).max() + 1e-9
    # the scalars are held relative to the reference (kl and the actor
    # losses are ~1e-3, so an absolute term of tol would pass any value);
    # 1e-6 absolute covers a reference that is zero
    assert float(tl) == pytest.approx(float(jl), rel=tol, abs=1e-6)
    for k in ("loss_actor_rew", "loss_actor_total", "loss_vf_total", "kl",
              "entropy"):
        assert float(taux[k]) == pytest.approx(float(jaux[k]), rel=tol,
                                               abs=1e-6), k


@pytest.mark.parametrize("K", [2, 3])
def test_plain_grad_matches_pallas_interpret_bf16(K):
    """bf16 compute: the plain version's cast points are the Pallas
    kernel's."""
    params, data, talgo, state = _setup(K)
    _assert_matches_pallas(params, data, talgo, state, K, bf16=True)


# the envelope's edges: most value channels, widest observation and action,
# narrowest observation, the navigation tasks' widths, and row counts that are no multiple of 128 (the
# Pallas wrapper then takes the batch as one chunk)
EDGES = {"K6": (9, 2, 6, 256), "D12_A4": (12, 4, 2, 256),
         "D1": (1, 2, 2, 256), "rows200": (9, 2, 2, 200),
         "rows72_K3_A3": (5, 3, 3, 72),
         # the navigation tasks' widths: Goal (21) and Button (54)
         "D21": (21, 2, 2, 256), "D54": (54, 2, 2, 200),
         # the velocity suite's actions: HalfCheetah (D 17, A 6), and the
         # envelope's 8 at the narrowest and widest observations
         "D17_A6": (17, 6, 2, 256), "D9_A8_K6": (9, 8, 6, 256),
         "D64_A8_rows200": (64, 8, 3, 200),
         # above the resident tiles' 64 observations and the AM 8 layout's
         # 8 actions: Ant (105, 8), Humanoid (348, 17), and the corners
         "D65": (65, 2, 2, 256), "D105_A8": (105, 8, 2, 256),
         "D348_A17": (348, 17, 2, 256), "A9": (9, 9, 2, 200),
         "D129_A17_K6": (129, 17, 6, 200)}


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("edge", sorted(EDGES))
def test_plain_grad_matches_pallas_at_envelope_edges(edge, bf16):
    D_, A_, K, B = EDGES[edge]
    assert GradLayout(D=D_, H=128, A=A_, K=K).kernel_fits()
    params, data, talgo, state = _np_case(D_, A_, K, B, seed=len(edge))
    _assert_matches_pallas(params, data, talgo, state, K, bf16)


def test_plain_grad_without_cost_channel_matches_port_autograd():
    """K = 1 (no constraint): the Pallas wrapper does not take it, so the
    plain version is held against the port's autograd path."""
    _, data, talgo, state = _np_case(9, 2, 1, 200, seed=5)
    assert talgo.grad_layout.kernel_fits()
    obs, act, logp_old, adv, ret = (t(x) for x in data)
    lam, resc = torch.zeros(0), torch.tensor(1.0)
    _, _, g_plain = ppo_grad_minibatch(state.flat, talgo.grad_layout, obs,
                                       act, logp_old, normalize_adv(adv), ret,
                                       lam, resc)
    mb = OnPolicyBatch(obs, act, logp_old, adv, ret, torch.zeros_like(ret))
    _, _, g_auto = talgo._autograd_step(state, mb, lam, resc)
    np.testing.assert_allclose(n(g_auto), n(g_plain), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("n_col_groups", [16, 2])
def test_tile_offset_is_a_bijection_of_core_matrices(n_col_groups):
    """The bf16 kernel's shared-memory tile layout: every element of a
    128-row tile gets its own 2 bytes, a core matrix is 8 rows of 16
    contiguous bytes, 128 bytes in all."""
    rows, cols = 128, 8 * n_col_groups
    off = np.array([[tile_offset(r, c, n_col_groups) for c in range(cols)]
                    for r in range(rows)])
    assert sorted(off.ravel()) == list(range(0, 2 * rows * cols, 2))
    assert (off[:, 1:8] - off[:, :7] == 2).all()        # 8 columns: 16 bytes
    assert (off[1:8, 0] - off[:7, 0] == 16).all()       # next row of a core
    core = off[8:16, 8:16]
    assert core.max() - core.min() == 126               # 128 bytes a core
    assert off[8, 0] - off[0, 0] == 128 * n_col_groups  # next row group
    assert off[0, 8] - off[0, 0] == 128                 # next column group


def test_tf32_split():
    """The f32 kernel's operand split: both parts are TF32 values (the 13
    low bits zero), hi is x rounded to nearest with ties away from zero,
    and x - hi - lo is within 2^-22 |x|."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=4096) * np.exp(4 * rng.normal(size=4096))
    x = torch.as_tensor(x.astype(np.float32))
    hi, lo = tf32_split(x)
    for part in (hi, lo):
        assert (part.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((x - hi).abs() <= 2.0 ** -11 * x.abs()).all()
    assert ((x - hi - lo).abs() <= 2.0 ** -22 * x.abs()).all()
    # 1 + 2^-11 lies halfway between the TF32 values 1 and 1 + 2^-10
    tie = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11),
                        1 + 2 ** -11 - 2 ** -23])
    assert tf32_split(tie)[0].tolist() == [1 + 2 ** -10, -(1 + 2 ** -10), 1.0]


class _TF32Products(TorchFunctionMode):
    """Every matrix product as the f32 kernel forms it from the operands'
    TF32 parts: hi_a hi_b + hi_a lo_b + lo_a hi_b (``terms=3``), or
    hi_a hi_b alone (``terms=1``, one TF32 product)."""

    def __init__(self, terms: int):
        super().__init__()
        self.terms = terms

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", None) == "matmul":
            (ah, al), (bh, bl) = tf32_split(args[0]), tf32_split(args[1])
            return ah @ bh if self.terms == 1 else ah @ bl + al @ bh + ah @ bh
        return func(*args, **(kwargs or {}))


def test_three_tf32_products_hold_float32_accuracy():
    """The f32 kernel's error model on the plain version's operands (B 256,
    D 9, A 2, K 2): with every matrix product taken as three TF32 products
    the gradient stays within 2e-6 of each tensor's largest entry of the
    float32 plain version (the card's tolerance is 1e-5), where one TF32
    product is off by more than 1e-5. The heads, which the kernel keeps on
    the FP32 pipes, are split here too. The rows lie clear of the ReLU
    kinks, where any two float32 computations may differ."""
    B, D_, A_, K = 256, 9, 2, 2
    talgo = PPOLag(D_, A_, device="cpu")
    layout = talgo.grad_layout
    assert layout.K == K
    flat = talgo.init(seed=0).flat
    rng = np.random.default_rng(7)
    f32 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32))
    obs = redraw_near_kinks(flat, layout, f32(rng.normal(size=(B, D_))),
                            lambda n_: f32(rng.normal(size=(n_, D_))))
    assert float(relu_margin(flat, layout, obs).min()) >= KINK_MARGIN
    act = f32(np.clip(0.5 * rng.normal(size=(B, A_)), -0.99, 0.99))
    logp = policy_logp(flat, layout, obs, act)
    logp_old = torch.where(torch.arange(B) % 2 == 0, logp,
                           logp + f32(0.1 * rng.normal(size=B)))
    args = (flat, layout, obs, act, logp_old,
            normalize_adv(f32(rng.normal(size=(B, K)))),
            f32(rng.normal(size=(B, K))), torch.tensor([1.5]),
            torch.tensor(0.4))
    kw = dict(eps_clip=0.2, vf_coef=0.25, bf16=False)
    ref, ref_aux = ppo_grad_plain(*args, **kw)

    def worst(terms):
        with _TF32Products(terms):
            g, aux = ppo_grad_plain(*args, **kw)
        return max(float((layout.views(g)[k] - r).abs().max() / r.abs().max())
                   for k, r in layout.views(ref).items()), aux

    err3, aux3 = worst(3)
    err1, _ = worst(1)
    assert err3 <= 2e-6, err3
    assert err1 > 1e-5, err1
    torch.testing.assert_close(aux3, ref_aux, rtol=1e-5, atol=1e-6)


# the generic form's card-test shapes (tests/test_torch_cuda.py ANY_SHAPES)
# as (D, H1, H2, A, K), and how its row kernel stages their trunk products'
# slices in f32: 16 bytes at a time in the instance of up to 8 actions
ANY_STAGING_F32 = [((9, 256, 256, 2, 2), "vector"),
                   ((9, 64, 64, 2, 2), "vector"),
                   ((9, 128, 128, 33, 2), "scalar"),
                   ((348, 128, 128, 40, 2), "scalar"),
                   ((21, 256, 128, 3, 3), "vector"),
                   ((17, 32, 48, 33, 6), "scalar"),
                   ((1, 16, 16, 1, 1), "vector"),
                   ((105, 512, 512, 8, 2), "vector")]


@pytest.mark.parametrize("dims,form", ANY_STAGING_F32)
def test_any_staging_follows_the_shape(dims, form):
    """The generic form's staging (``any_staging``, counted in
    ``STAGINGS``) is a function of the layout: "vector" for f32 up to 8
    actions, the row kernel instance the f32 main paths launch, "scalar"
    for f32 above 8 actions and for every bf16 layout."""
    from fsrl_torch.ops.fused_ppo_grad import (GradLayout, any_staging,
                                               kernel_form)
    D, H1, H2, A, K = dims
    layout = GradLayout(D, H1, A, K, H2)
    assert kernel_form(layout) == "any"
    assert any_staging(layout, False) == form
    assert any_staging(layout, True) == "scalar"
