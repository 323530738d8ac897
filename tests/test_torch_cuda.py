"""Kernels K1 and K2 against their plain versions on the card. These need
an NVIDIA GPU with ``nvcc`` and skip elsewhere; run them on the card with

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import pytest
import torch

from fsrl_torch.ops import kernels

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_gae_kernel_matches_plain(cuda):
    from fsrl_torch.ops.gae import gae_advantages
    from fsrl_torch.ops.gae_kernel import gae_advantages_fused
    g = torch.Generator(device=cuda).manual_seed(0)
    T, N, K = 33, 1000, 3          # N*K not a multiple of the block
    m, v, vn = (torch.randn(T, N, K, device=cuda, generator=g)
                for _ in range(3))
    end = torch.rand(T, N, device=cuda, generator=g) < 0.1
    before = kernels.LAUNCHES["gae"]
    a, r = gae_advantages_fused(m, v, vn, end, 0.99, 0.95)
    assert kernels.LAUNCHES["gae"] == before + 1
    pa, pr = gae_advantages(m, v, vn, end, 0.99, 0.95)
    # same operation order, no FMA contraction in the kernel
    torch.testing.assert_close(a, pa, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(r, pr, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_fused_grad_kernel_matches_plain(cuda, bf16):
    from fsrl_torch.algos.common import normalize_adv
    from fsrl_torch.algos.ppo_lag import PPOLag
    from fsrl_torch.ops.fused_ppo_grad import policy_logp, ppo_grad_rows
    B, D, A, K = 1000, 9, 2, 2     # a ragged last chunk of rows
    algo = PPOLag(D, A, device=cuda)
    state = algo.init(seed=0)
    g = torch.Generator(device=cuda).manual_seed(1)
    obs = torch.randn(B, D, device=cuda, generator=g)
    if not bf16:
        obs = _off_kinks(state.flat, algo.grad_layout, obs, g)
    act = torch.randn(B, A, device=cuda, generator=g).clamp(-0.99, 0.99)
    logp = policy_logp(state.flat, algo.grad_layout, obs, act, bf16=bf16)
    logp_old = torch.where(torch.arange(B, device=cuda) % 2 == 0, logp,
                           logp + 0.1 * torch.randn(B, device=cuda,
                                                    generator=g))
    adv = normalize_adv(torch.randn(B, K, device=cuda, generator=g))
    ret = torch.randn(B, K, device=cuda, generator=g)
    lam, resc = torch.tensor([1.5], device=cuda), torch.tensor(0.4,
                                                               device=cuda)
    args = (state.flat, algo.grad_layout, obs, act, logp_old, adv, ret, lam,
            resc)
    gk, ak = ppo_grad_rows(*args, eps_clip=0.2, vf_coef=0.25, bf16=bf16)
    _assert_close_to_plain(args, gk, ak, bf16)


def _off_kinks(flat, layout, obs, g):
    """``obs`` with the rows near a ReLU kink drawn again: there two float32
    computations may take different sides of the ReLU (``relu_margin``)."""
    from fsrl_torch.ops.fused_ppo_grad import redraw_near_kinks
    return redraw_near_kinks(flat, layout, obs, lambda n: torch.randn(
        n, obs.shape[1], device=obs.device, generator=g))


def _plain64(args, kw):
    """The plain version in float64 on the same float32 inputs."""
    from fsrl_torch.ops.fused_ppo_grad import ppo_grad_plain
    return ppo_grad_plain(*(x.double() if torch.is_tensor(x) else x
                            for x in args), **kw)


def _assert_close_to_plain(args, gk, ak, bf16):
    """The kernel's gradient ``gk`` and aux row ``ak`` against the plain
    version on ``args``. f32 (three TF32 products for each product): 1e-5
    of each gradient tensor's largest entry, as the plain version is held to
    JAX's Pallas kernel on the CPU; one TF32 product (~5e-4) fails it. The
    f32 aux entries are sums over the rows (sum(logp_old - logp),
    sum(ratio * cadv)) that carry each row's float32 rounding, so at 32,768
    rows the plain f32 version is itself over 1e-5 from the float64
    evaluation and cannot be the yardstick at rtol 1e-5: each entry must be
    no farther from the float64 evaluation than the plain f32 version,
    within rtol 1e-5 plus 1e-8 a row (:func:`_assert_aux_no_farther`).
    bf16: an operand may round
    to the neighbouring bf16 value when its f32 sum came out in another
    order, so 1e-2."""
    from fsrl_torch.ops.fused_ppo_grad import ppo_grad_plain
    kw = dict(eps_clip=0.2, vf_coef=0.25, bf16=bf16)
    gp, ap = ppo_grad_plain(*args, **kw)
    layout = args[1]
    tol = 1e-2 if bf16 else 1e-5
    for name, x in layout.views(gk).items():
        ref = layout.views(gp)[name]
        assert float((x - ref).abs().max()) <= tol * float(
            ref.abs().max()) + 1e-7, name
    if bf16:
        torch.testing.assert_close(ak, ap, rtol=tol, atol=1e-5)
    else:
        _assert_aux_no_farther(ak, ap, _plain64(args, kw)[1], len(args[2]))


def _assert_aux_no_farther(ak, ap, a64, B):
    """Each f32 aux entry of the kernel no farther from the float64
    evaluation than the plain f32 version's, plus rtol 1e-5 and 1e-8 for
    each of the B rows. An entry is a sum over the rows that the update
    divides by B, and each row's float32 rounding of its ratio (~1e-7) adds
    up to ~sqrt(B) 1e-7 where the sum cancels: the atol is 1e-8 on the mean
    that the update reads."""
    bound = (ap.double() - a64).abs() + 1e-5 * a64.abs() + 1e-8 * B
    assert ((ak.double() - a64).abs() <= bound).all(), (ak, ap, a64)


def _grad_case(cuda, B, D, A, K, bf16, seed=1, off_kinks=True,
               hidden=(128, 128)):
    """Arguments of the fused grad kernel at one shape, half the rows with
    ratio == 1 exactly in the plain version (f32 with ``off_kinks``: no row
    on a ReLU kink)."""
    from fsrl_torch.algos.common import normalize_adv
    from fsrl_torch.algos.ppo_lag import PPOLag
    from fsrl_torch.ops.fused_ppo_grad import policy_logp
    algo = PPOLag(D, A, num_costs=K - 1, cost_limit=[10.0] * (K - 1),
                  hidden_sizes=hidden, device=cuda)
    state = algo.init(seed=seed)
    g = torch.Generator(device=cuda).manual_seed(seed)
    obs = torch.randn(B, D, device=cuda, generator=g)
    if not bf16 and off_kinks:
        obs = _off_kinks(state.flat, algo.grad_layout, obs, g)
    act = (0.5 * torch.randn(B, A, device=cuda, generator=g)).clamp(-0.99,
                                                                    0.99)
    logp = policy_logp(state.flat, algo.grad_layout, obs, act, bf16=bf16)
    logp_old = torch.where(
        torch.arange(B, device=cuda) % 2 == 0, logp,
        logp + 0.1 * torch.randn(B, device=cuda, generator=g)).contiguous()
    adv = normalize_adv(torch.randn(B, K, device=cuda, generator=g))
    ret = torch.randn(B, K, device=cuda, generator=g)
    lam = torch.linspace(0.5, 2.0, K - 1, device=cuda)
    resc = 1.0 / (lam.sum() + 1.0)
    return [state.flat, algo.grad_layout, obs, act, logp_old, adv, ret, lam,
            resc]


# ragged strips, a T above one time tile, a column count that takes the
# 4-byte path, and the main path's shape
@pytest.mark.parametrize("T,N,K", [(33, 1000, 3), (150, 516, 2),
                                   (65, 1001, 3), (64, 4096, 2)])
def test_gae_kernel_equals_plain_bit_for_bit(cuda, T, N, K):
    from fsrl_torch.ops.gae import gae_advantages
    from fsrl_torch.ops.gae_kernel import gae_advantages_fused
    g = torch.Generator(device=cuda).manual_seed(T)
    m, v, vn = (torch.randn(T, N, K, device=cuda, generator=g)
                for _ in range(3))
    end = torch.rand(T, N, device=cuda, generator=g) < 0.05
    a, r = gae_advantages_fused(m, v, vn, end, 0.99, 0.95)
    a2, r2 = gae_advantages_fused(m, v, vn, end, 0.99, 0.95)
    pa, pr = gae_advantages(m, v, vn, end, 0.99, 0.95)
    # the plain loop's operation order, no FMA contraction: no rounding
    # differs
    assert torch.equal(a, pa) and torch.equal(r, pr)
    assert torch.equal(a, a2) and torch.equal(r, r2)


# the edges of the kernels' envelope, and the main path's shape; the
# navigation tasks' widths (Goal 21, Button 54) and the widest corner; the
# instances for 5 to 8 actions: the host path's minibatch (256 rows, D 17,
# A 6), the corners at 8 actions and a ragged row count; above 64
# observations and 8 actions: Humanoid-v5 (348, 17) at the host path's
# minibatch, Ant-v5 (105, 8) with the most value channels, a ragged count
# at 129 and Humanoid-v4's 376 observations with 24 actions
ENVELOPE_EDGES = [
    (1000, 9, 2, 2), (100, 9, 2, 2), (4096, 9, 2, 1), (4096, 9, 2, 6),
    (4096, 12, 4, 2), (4096, 1, 2, 2), (1000, 5, 3, 3), (32768, 9, 2, 2),
    (4096, 21, 2, 2), (1000, 54, 2, 2), (4096, 64, 4, 6),
    (256, 17, 6, 2), (4096, 9, 8, 6), (4096, 64, 8, 6), (1000, 33, 5, 3),
    (256, 348, 17, 2), (4096, 105, 8, 6), (1000, 129, 17, 3),
    (4096, 376, 24, 2)]


def _check_at_shape(cuda, B, D, A, K, bf16, hidden=(128, 128)):
    from fsrl_torch.ops.fused_ppo_grad import launch_name, ppo_grad_rows
    args = _grad_case(cuda, B, D, A, K, bf16=bf16, hidden=hidden)
    kw = dict(eps_clip=0.2, vf_coef=0.25, bf16=bf16)
    name = launch_name(args[1], bf16)
    before = kernels.LAUNCHES[name]
    gk, ak = ppo_grad_rows(*args, **kw)
    g2, a2 = ppo_grad_rows(*args, **kw)
    assert kernels.LAUNCHES[name] == before + 2
    _assert_close_to_plain(args, gk, ak, bf16)
    # no atomics, fixed summation orders: a launch reproduces bit for bit
    assert torch.equal(gk, g2) and torch.equal(ak, a2)


@pytest.mark.parametrize("B,D,A,K", ENVELOPE_EDGES)
def test_fused_grad_kernel_at_envelope_edges(cuda, B, D, A, K):
    """The bf16 (wgmma) kernel."""
    _check_at_shape(cuda, B, D, A, K, bf16=True)


@pytest.mark.parametrize("B,D,A,K", ENVELOPE_EDGES)
def test_fused_grad_f32_kernel_at_envelope_edges(cuda, B, D, A, K):
    """The f32 kernel (three TF32 products for each product)."""
    _check_at_shape(cuda, B, D, A, K, bf16=False)


# the generic form (csrc/fused_ppo_grad_any.cu): (B, D, H1, H2, A, K) at
# hidden (256, 256) and (64, 64), uneven widths, above 32 actions at the
# default width, the most value channels, K 1 and D 1, ragged row counts,
# rows below one 64-row block of the row kernel and one row past it
ANY_SHAPES = [(4096, 9, 256, 256, 2, 2), (4096, 9, 64, 64, 2, 2),
              (4096, 9, 128, 128, 33, 2), (256, 348, 128, 128, 40, 2),
              (4096, 21, 256, 128, 3, 3), (1000, 17, 32, 48, 33, 6),
              (100, 1, 16, 16, 1, 1), (1000, 105, 512, 512, 8, 2),
              (1, 9, 256, 256, 2, 2), (63, 9, 256, 256, 2, 2),
              (65, 348, 128, 128, 40, 2), (63, 105, 512, 512, 8, 2)]


@pytest.mark.parametrize("B,D,H1,H2,A,K", ANY_SHAPES)
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_fused_grad_any_kernel_matches_plain(cuda, bf16, B, D, H1, H2, A,
                                             K):
    """The generic form against the plain version, at the tuned forms'
    tolerances, counted under its own name, two launches bit for bit."""
    from fsrl_torch.ops.fused_ppo_grad import kernel_form
    assert kernel_form(_grad_case(cuda, 1, D, A, K, bf16,
                                  hidden=(H1, H2))[1]) == "any"
    _check_at_shape(cuda, B, D, A, K, bf16, hidden=(H1, H2))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fused_grad_f32_kernel_on_natural_rows(cuda, seed):
    """The f32 kernel on the main path's shape with its rows as drawn, ReLU
    kinks included: there a row can take the other side of a ReLU in any
    float32 computation, and its whole gradient through the unit moves
    (~1e-3 of a tensor's largest entry at 32,768 rows), so the kernel is
    measured against the float64 evaluation of the plain version. Each
    gradient tensor must be no farther from it than the plain f32 version
    plus 1e-5 of its largest entry, and each aux entry within the bound of
    :func:`_assert_aux_no_farther`."""
    _check_natural_rows(cuda, seed)


@pytest.mark.parametrize("seed", [1])
def test_fused_grad_any_f32_kernel_on_natural_rows(cuda, seed):
    """The generic form's f32 products (three TF32 products, float64
    retakes near a kink) at hidden (256, 256) on natural rows, held as the
    tuned f32 kernel is."""
    _check_natural_rows(cuda, seed, hidden=(256, 256), form="any")


@pytest.mark.parametrize("hidden", [(256, 256), (320, 192)])
def test_fused_grad_any_f32_vector_staging_repeats(cuda, hidden):
    """The generic form's f32 row kernel at up to 8 actions loads and
    stores the slices of its trunk products 16 bytes at a time (the
    "vector" staging), at hidden (256, 256) and at unequal widths. At 4096
    rows as drawn, ReLU kinks and their float64 retakes included: counted
    as ``fused_ppo_grad_any_f32`` and as the "vector" staging, two launches
    bit for bit."""
    from fsrl_torch.ops import fused_ppo_grad as fpg
    args = _grad_case(cuda, 4096, 9, 2, 2, bf16=False, off_kinks=False,
                      hidden=hidden)
    kw = dict(eps_clip=0.2, vf_coef=0.25, bf16=False)
    assert fpg.launch_name(args[1], False) == "fused_ppo_grad_any_f32"
    assert fpg.any_staging(args[1], False) == "vector"
    before = kernels.LAUNCHES["fused_ppo_grad_any_f32"]
    staged = fpg.STAGINGS["vector"]
    gk, ak = fpg.ppo_grad_rows(*args, **kw)
    g2, a2 = fpg.ppo_grad_rows(*args, **kw)
    assert kernels.LAUNCHES["fused_ppo_grad_any_f32"] == before + 2
    assert fpg.STAGINGS["vector"] == staged + 2
    assert torch.equal(gk, g2) and torch.equal(ak, a2)


def _check_natural_rows(cuda, seed, hidden=(128, 128), form="tuned"):
    from fsrl_torch.ops.fused_ppo_grad import (kernel_form, ppo_grad_plain,
                                               ppo_grad_rows)
    args = _grad_case(cuda, 32768, 9, 2, 2, bf16=False, seed=seed,
                      off_kinks=False, hidden=hidden)
    layout = args[1]
    assert kernel_form(layout) == form
    kw = dict(eps_clip=0.2, vf_coef=0.25, bf16=False)
    gk, ak = ppo_grad_rows(*args, **kw)
    gp, ap = ppo_grad_plain(*args, **kw)
    g64, a64 = _plain64(args, kw)
    for (name, x), p, ref in zip(layout.views(gk).items(),
                                 layout.views(gp).values(),
                                 layout.views(g64).values()):
        scale = float(ref.abs().max())
        assert float((x - ref).abs().max()) <= float(
            (p - ref).abs().max()) + 1e-5 * scale, name
    _assert_aux_no_farther(ak, ap, a64, 32768)


def test_fused_grad_f32_two_launches_identical(cuda):
    from fsrl_torch.ops.fused_ppo_grad import ppo_grad_rows
    args = _grad_case(cuda, 1000, 9, 2, 2, bf16=False)
    before = dict(kernels.LAUNCHES)
    g1, a1 = ppo_grad_rows(*args, bf16=False)
    g2, a2 = ppo_grad_rows(*args, bf16=False)
    assert torch.equal(g1, g2) and torch.equal(a1, a2)
    # the f32 kernel is counted apart from the bf16 one
    assert kernels.LAUNCHES["fused_ppo_grad_f32"] == before.get(
        "fused_ppo_grad_f32", 0) + 2
    assert kernels.LAUNCHES["fused_ppo_grad"] == before.get(
        "fused_ppo_grad", 0)


@pytest.mark.parametrize("D,A", [(9, 2), (348, 17)])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_fused_grad_wrapper_raises_rather_than_falling_back(cuda, bf16, D,
                                                            A):
    """At the main path's width and at Humanoid's (the sliced form)."""
    from fsrl_torch.ops.fused_ppo_grad import (KERNEL_A_MAX, GradLayout,
                                               ppo_grad_rows)
    args = _grad_case(cuda, 256, D, A, 2, bf16=bf16)
    before = sum(kernels.LAUNCHES.values())
    bad = list(args)
    bad[2] = torch.randn(D, 256, device=cuda).T          # not contiguous
    with pytest.raises(ValueError):
        ppo_grad_rows(*bad, bf16=bf16)
    bad = list(args)
    bad[3] = args[3].double()                            # wrong dtype
    with pytest.raises(ValueError):
        ppo_grad_rows(*bad, bf16=bf16)
    bad = list(args)
    bad[5] = args[5][:, :1].contiguous()                 # wrong shape
    with pytest.raises(ValueError):
        ppo_grad_rows(*bad, bf16=bf16)
    bad = list(args)
    bad[1] = GradLayout(D=D, H=128, A=A, K=7)            # outside the envelope
    with pytest.raises(ValueError):
        ppo_grad_rows(*bad, bf16=bf16)
    bad = list(args)                                     # outside, generic form
    bad[1] = GradLayout(D=D, H=64, A=KERNEL_A_MAX + 1, K=7)
    with pytest.raises(ValueError):
        ppo_grad_rows(*bad, bf16=bf16)
    assert sum(kernels.LAUNCHES.values()) == before


def test_gae_wrapper_raises_rather_than_falling_back(cuda):
    from fsrl_torch.ops.gae_kernel import gae_advantages_fused
    T, N, K = 8, 64, 2
    m, v, vn = (torch.randn(T, N, K, device=cuda) for _ in range(3))
    end = torch.zeros(T, N, dtype=torch.bool, device=cuda)
    before = kernels.LAUNCHES["gae"]
    with pytest.raises(ValueError):                      # not contiguous
        gae_advantages_fused(m.transpose(0, 1), v, vn, end, 0.99, 0.95)
    with pytest.raises(ValueError):                      # wrong dtype
        gae_advantages_fused(m.double(), v, vn, end, 0.99, 0.95)
    with pytest.raises(ValueError):                      # flags not bool
        gae_advantages_fused(m, v, vn, end.float(), 0.99, 0.95)
    assert kernels.LAUNCHES["gae"] == before


def test_python_mirrors_of_the_kernels_tiling_agree_with_the_library(cuda):
    """``STRIP`` / ``TIME_TILE`` and ``tile_offset`` are copies of constants
    in the CUDA sources that tests and callers pick shapes from: the built
    library reports what the kernels really use."""
    from fsrl_torch.ops.fused_ppo_grad import tile_offset
    from fsrl_torch.ops.gae_kernel import STRIP, TIME_TILE
    lib = kernels.library()
    assert (lib.fsrl_gae_strip(), lib.fsrl_gae_time_tile()) == (STRIP,
                                                                TIME_TILE)
    for ncg in (16, 2):
        for r in range(128):
            for c in range(8 * ncg):
                assert lib.fsrl_ppo_grad_tile_offset(r, c, ncg) == \
                    tile_offset(r, c, ncg), (r, c, ncg)


def _one_update(cls, dev, D=9, A=2, act_scale=1.0, logp_mean=-2.0, **kw):
    """One small f32 update of ``cls`` on ``dev`` from numpy-seeded rows of
    widths ``D`` and ``A`` (actions ``act_scale`` times normal draws, old
    log-probs normal about ``logp_mean``), with the shuffle drawn on the
    CPU: the flat parameters and metrics."""
    import numpy as np

    from fsrl_torch.types import TileLayout, Transition, draw_tile_perms
    rng = np.random.default_rng(0)
    T, N = 32, 64
    rows = {
        "obs": rng.normal(size=(T, N, D)),
        "act": act_scale * rng.normal(size=(T, N, A)),
        "obs_next": rng.normal(size=(T, N, D)),
        "reward": rng.normal(size=(T, N)), "cost": rng.random((T, N, 1)),
        "terminated": rng.random((T, N)) < 0.02,
        "truncated": rng.random((T, N)) < 0.02,
        "logp": rng.normal(size=(T, N)) + logp_mean}
    algo = cls(D, A, cost_limit=5.0, device=dev, **kw)
    state = algo.init(seed=1)
    tr = Transition(**{
        k: torch.as_tensor(v, dtype=torch.bool if v.dtype == bool
                           else torch.float32, device=dev)
        for k, v in rows.items()})
    extra = {}
    if cls.name in ("ppo_lag", "focops"):
        perms = draw_tile_perms(TileLayout.of(T * N, 2), 2,
                                torch.Generator().manual_seed(2), "cpu",
                                roll_per_epoch=cls.name == "focops")
        extra["perms"] = tuple(p.to(dev) for p in perms)
    before = dict(kernels.LAUNCHES)
    state, m = algo.update(state, tr, torch.tensor([7.0], device=dev),
                           torch.tensor(3, dtype=torch.int32, device=dev),
                           None, **extra)
    launched = {k: v - before.get(k, 0) for k, v in kernels.LAUNCHES.items()
                if v != before.get(k, 0)}
    m = {k: float(v) for k, v in m.items()}
    if cls.name == "trpo_lag":       # the index is not among its metrics
        m["loss/backtracks"] = float(algo.last_backtracks[-1])
    return algo, state.flat.cpu(), m, launched


@pytest.mark.parametrize("name", ["ppo_lag", "ppo_lag_humanoid",
                                  "ppo_lag_h64x32", "focops", "trpo_lag",
                                  "cpo"])
def test_update_on_the_card_matches_the_cpu(cuda, name):
    """One update of each on-policy algorithm on the card (GAE through
    kernel K1; PPO-Lag's 2 x 2 grad steps through the f32 K2 kernel, also
    at Humanoid-v5's widths, D 348 and A 17, and through the generic form
    at hidden (64, 32)) against the same update on the CPU."""
    from fsrl_torch.ops.fused_ppo_grad import launch_name
    from fsrl_torch.algos.common import split_flat
    from fsrl_torch.algos.cpo import CPO
    from fsrl_torch.algos.focops import FOCOPS
    from fsrl_torch.algos.ppo_lag import PPOLag
    from fsrl_torch.algos.trpo_lag import TRPOLag
    mb = dict(repeat=2, n_minibatches=2)
    cls, kw = {"ppo_lag": (PPOLag, mb),
               # actions and old log-probs of the policy's own scale at 17
               # actions (log-prob about -9), so that the ratio is near 1
               "ppo_lag_humanoid": (PPOLag, dict(mb, D=348, A=17,
                                                 act_scale=0.3,
                                                 logp_mean=-9.0)),
               "ppo_lag_h64x32": (PPOLag, dict(mb, hidden_sizes=(64, 32))),
               "focops": (FOCOPS, mb),
               "trpo_lag": (TRPOLag, dict(target_kl=0.01)),
               "cpo": (CPO, dict())}[name]
    algo, fc, mc, n_cpu = _one_update(cls, "cpu", **kw)
    _, fg, mg, n_gpu = _one_update(cls, cuda, **kw)
    assert n_cpu == {}
    assert n_gpu == ({"gae": 1, launch_name(algo.grad_layout, False): 4}
                     if cls is PPOLag else {"gae": 1})
    start = algo.init(seed=1)
    model = start.params
    if cls in (PPOLag, FOCOPS):
        # Adam on gradients ~1e-7 apart: 1e-5 after 4 steps of lr 3e-4
        assert float((fc - fg).abs().max()) < 1e-5
    else:
        # the trust-region step relative to its length (CG amplifies the
        # devices' summation orders). The critics take 10 or 20 Adam steps:
        # where a gradient entry is rounding noise, m / sqrt(v) makes a
        # full step of lr out of it, so their move is held as a whole, to
        # 2e-2 of its length, and entry by entry to 5 steps of lr 1e-3
        (ac, cc), (ag, cg) = split_flat(model, fc), split_flat(model, fg)
        a0, c0 = split_flat(model, start.flat)
        assert float((ac - ag).norm() / (ac - a0).norm()) < 5e-3
        assert float((cc - cg).norm() / (cc - c0).norm()) < 2e-2
        assert float((cc - cg).abs().max()) < 5e-3
        assert mc["loss/backtracks"] == mg["loss/backtracks"]
    if name == "cpo":
        assert mc["loss/optim_case"] == mg["loss/optim_case"]
    for k in mc:
        rel = 5e-2 if k == "loss/optim_R" else 1e-2
        assert mg[k] == pytest.approx(mc[k], rel=rel, abs=1e-5), k


def _offpolicy_step(cls, dev):
    """One ``update_step`` of ``cls`` on ``dev`` from the seed-1 state on
    a numpy-seeded buffer, with CPU-drawn indices and noise: the flat
    parameters before and after, and the metrics."""
    import numpy as np

    from fsrl_torch.algos.offpolicy_base import make_nstep_view
    from fsrl_torch.data.buffer import ReplayBuffer
    from fsrl_torch.types import Transition
    rng = np.random.default_rng(0)
    T, N, D, A, B = 20, 8, 8, 2, 128
    f = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=torch.float32,
                                   device=dev)
    tr = Transition(obs=f(T, N, D), act=f(T, N, A), obs_next=f(T, N, D),
                    reward=f(T, N), cost=f(T, N, 1).abs(),
                    terminated=torch.as_tensor(rng.random((T, N)) < 0.05,
                                               device=dev),
                    truncated=torch.zeros(T, N, dtype=torch.bool,
                                          device=dev),
                    logp=f(T, N))
    buf = ReplayBuffer(32, N, dev)
    bs = buf.add_segment(buf.init(D, A), tr)
    g = torch.Generator().manual_seed(1)
    draws = dict(rows=torch.randint(0, T, (B,), generator=g),
                 envs=torch.randint(0, N, (B,), generator=g),
                 noise_t=torch.randn(B, A, generator=g),
                 noise_a=torch.randn(B, A, generator=g),
                 noise_p=torch.randn(16, B, A, generator=g))
    algo = cls(D, A, cost_limit=5.0, batch_size=B, device=dev)
    state = algo.init(seed=1)
    start = state.params.flat.cpu().clone()
    state, m = algo.update_step(state, buf, bs, view=make_nstep_view(buf, bs),
                                draws={k: v.to(dev) for k, v in draws.items()})
    return start, state.params.flat.cpu(), {k: float(v) for k, v in m.items()}


@pytest.mark.parametrize("name", ["ddpg_lag", "sac_lag", "cvpo"])
def test_offpolicy_update_step_on_the_card_matches_the_cpu(cuda, name):
    """One off-policy grad step on the card against the same step on the
    CPU: no kernel of the port runs on these paths."""
    from fsrl_torch.algos.cvpo import CVPO
    from fsrl_torch.algos.ddpg_lag import DDPGLag
    from fsrl_torch.algos.sac_lag import SACLag
    cls = {"ddpg_lag": DDPGLag, "sac_lag": SACLag, "cvpo": CVPO}[name]
    before = sum(kernels.LAUNCHES.values())
    s0, fc, mc = _offpolicy_step(cls, "cpu")
    _, fg, mg = _offpolicy_step(cls, cuda)
    assert sum(kernels.LAUNCHES.values()) == before
    # Adam's first step is about lr * sign(g): gradients ~1e-7 apart give
    # weights within 1e-6, except an entry whose gradient is rounding noise
    # (at most 1e-3 of them, each within two steps of lr 1e-3)
    diff = (fc - fg).abs()
    assert float(diff.max()) <= 2e-3 * 1.001
    assert float((diff > 1e-6).float().mean()) <= 1e-3
    assert set(mc) == set(mg)
    for k in mc:
        assert mg[k] == pytest.approx(mc[k], rel=1e-4, abs=1e-5), k


# --------------------------------------------------------------- CUDA graphs
def _same(a, b):
    """Two trainers' state, env state and statistics equal bit for bit."""
    from fsrl_torch.utils.checkpoint import to_state_dict

    def flat(d, p=""):
        if isinstance(d, dict):
            for k, v in d.items():
                yield from flat(v, f"{p}.{k}")
        else:
            yield p, d
    for name in ("state", "stats"):
        sa, sb = (dict(flat(to_state_dict(getattr(t, name)))) for t in (a, b))
        assert all(torch.equal(sa[k], sb[k]) for k in sa), name
    assert torch.equal(a.env_state.obs, b.env_state.obs)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def _onpolicy(task="SafetyCarCircle-v0", **kw):
    from fsrl_torch.agent import PPOLagAgent
    from fsrl_torch.trainer import OnpolicyTrainer
    agent = PPOLagAgent(task, cost_limit=10.0, repeat=2, n_minibatches=2)
    return OnpolicyTrainer(agent.algo, agent.env, None, n_envs=64,
                           steps_per_collect=16, seed=0, verbose=False,
                           state=agent.state, **kw)


def test_fused_dispatch_replays_the_eager_cycles(cuda):
    """``fuse_iters`` 2: the eager warm-up, then one capture replayed; 3
    dispatches equal 6 eager cycles bit for bit, and the capture launched
    each kernel twice the eager cycle's count (the rollout kernel once a
    cycle)."""
    g, e = _onpolicy(fuse_iters=2), _onpolicy()
    for _ in range(3):
        g._run_iter()
    for _ in range(6):
        e.cycle()
    assert g.dispatch_mode == "graph of 2 cycles"
    assert (g.graph.captures, g.graph.replays) == (1, 2)
    assert dict(g.graph.launches) == {"gae": 2, "fused_ppo_grad_f32": 8,
                                      "rollout": 2}
    _same(g, e)


def test_rollout_unroll_replays_the_eager_rollout(cuda):
    """``rollout_unroll`` 5 over 16 steps: graphs of 5 steps, 3 a rollout,
    and one of the last step. On DroneRun, whose rollout takes the loop
    (on the car and ball envs the rollout kernel runs a segment in one
    launch, and no step graph is made)."""
    from fsrl_torch.trainer import graphs
    graphs.CAPTURES.clear()
    graphs.REPLAYS.clear()
    g = _onpolicy("SafetyDroneRun-v0", rollout_unroll=5)
    e = _onpolicy("SafetyDroneRun-v0")
    for _ in range(3):
        g._run_iter()
        e.cycle()
    # each graph's first call is its warm-up: 5 steps captured in the
    # first rollout, the last step in the second
    assert graphs.CAPTURES == {"rollout of 5 steps": 1,
                               "rollout of 1 steps": 1}
    assert graphs.REPLAYS == {"rollout of 5 steps": 8,
                              "rollout of 1 steps": 2}
    _same(g, e)


def test_recurrent_rollout_unroll_replays_the_eager_cycles(cuda):
    """Recurrent PPO-Lag with ``rollout_unroll`` 5 over 16 steps: the
    update's BPTT start is the carry at the segment's start, which the
    rollout's graphs are given and write into. 4 cycles, the last three
    from a carry a graph wrote, equal the eager cycles bit for bit."""
    from fsrl_torch.agent import RecurrentPPOLagAgent
    from fsrl_torch.trainer import OnpolicyTrainer

    def trainer(**kw):
        agent = RecurrentPPOLagAgent("SafetyCarCircle-v0", cost_limit=10.0,
                                     repeat=2, n_minibatches=2)
        return OnpolicyTrainer(agent.algo, agent.env, None, n_envs=64,
                               steps_per_collect=16, seed=0, verbose=False,
                               state=agent.state, **kw)
    g, e = trainer(rollout_unroll=5), trainer()
    for _ in range(4):
        g._run_iter()
        e.cycle()
    assert g.dispatch_mode == "eager; rollout in graphs of 5 steps"
    _same(g, e)
    assert torch.equal(g.hidden, e.hidden)


def test_chunk_graphs_replay_the_eager_grad_steps(cuda):
    """``update_chunk`` 8 of 20 grad steps a collect: graphs of 8 and 4
    steps, the first call of each eager; the buffer fills in the second
    collect, after which the graphs are kept and replayed; equal to
    ``update_chunk`` 1 (no graph)."""
    from fsrl_torch.agent import SACLagAgent
    from fsrl_torch.trainer import OffpolicyTrainer

    def trainer(chunk):
        agent = SACLagAgent("SafetyBallCircle-v0", cost_limit=10.0,
                            batch_size=64)
        return OffpolicyTrainer(agent.algo, agent.env, None, n_envs=4,
                                steps_per_collect=25, buffer_size=200,
                                update_per_step=0.2, update_chunk=chunk,
                                seed=0, verbose=False, state=agent.state)
    g, e = trainer(8), trainer(1)
    for _ in range(4):
        g._run_iter()
        e._run_iter()
    assert g.chunk_sizes == [8, 8, 4] and sorted(g.chunk_graphs) == [4, 8]
    # 8 steps: the warm-up and a capture at 25 rows filled, a capture at
    # 50 (full), replayed 1 + 2 + 2 + 2 times
    assert (g.chunk_graphs[8].captures, g.chunk_graphs[8].replays) == (2, 7)
    assert (g.chunk_graphs[4].captures, g.chunk_graphs[4].replays) == (1, 3)
    _same(g, e)
    for name in vars(g.buf_state.data):
        assert torch.equal(getattr(g.buf_state.data, name),
                           getattr(e.buf_state.data, name))


def test_no_garbage_collection_during_a_capture(cuda):
    """A graph in a reference cycle (as a trainer and its graph's function
    are) is freed by the garbage collector, and freeing it during another
    graph's capture would end that capture: here a captured graph's last
    holder becomes cyclic garbage inside another capture, with the
    collector at its most eager."""
    import gc

    from fsrl_torch.trainer.graphs import Dispatch

    def captured():
        d = Dispatch(lambda c: (c * 2, None), name="garbage")
        x = torch.ones(4, device=cuda)
        for _ in range(2):                    # the warm-up, then a capture
            x, _ = d(x)
        return [d]
    held = captured()

    def fn(c):
        if torch.cuda.is_current_stream_capturing():
            cycle = [held.pop()]              # a young cycle, its only holder
            cycle.append(cycle)
            del cycle
            [[] for _ in range(1000)]         # a collection's worth
        return c + 1, None
    live = Dispatch(fn, name="live")
    x = torch.zeros(4, device=cuda)
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        for _ in range(3):                    # warm-up, capture, replay
            x, _ = live(x)
    finally:
        gc.set_threshold(*thresholds)
    assert torch.equal(x, torch.full((4,), 3.0, device=cuda))
    assert not held


def test_dispatch_refuses_a_nested_capture(cuda):
    from fsrl_torch.trainer.graphs import Dispatch
    inner = Dispatch(lambda c: (c + 1, None), name="inner")
    x = torch.zeros(2, device=cuda)
    inner(x)                                  # the warm-up
    outer = Dispatch(lambda c: (inner(c)[0], None), name="outer")
    outer(x)
    with pytest.raises(RuntimeError, match="inside another"):
        outer(x)


# ------------------------------------------------------------- the trace
def _marks_of(rec, d):
    return [m for m in rec.marks if m.dispatch == d]


def _inside_its_dispatch(rec, d, marks):
    """Each mark, on the host clock, inside dispatch ``d``'s span (give or
    take the calibration's error)."""
    (span,) = [s for s in rec.spans
               if s.name == "trainer.dispatch" and s.dispatch == d]
    err = rec.calibration["error_ns"]
    for m in marks:
        assert span.start_ns - err <= m.t_ns <= span.end_ns + err, (d, m)


def test_fused_replay_appends_four_marks_a_cycle(cuda):
    """``fuse_iters`` 2: the eager warm-up marks as it goes, the capture
    holds 8 marks, and each replay appends them: 4 a cycle in order, the
    card's times rising, each inside its dispatch's span."""
    from fsrl_torch.utils import profiling
    profiling.enable(True)
    profiling.reset()
    g = _onpolicy(fuse_iters=2)
    for _ in range(3):
        g._run_iter()
    assert g.graph.captured.marks == 8
    rec = profiling.record()
    assert rec.dispatches() == [1, 2, 3]
    assert rec.calibration["error_ns"] < 1e6
    for d in (1, 2, 3):
        marks = _marks_of(rec, d)
        assert [(m.cycle, m.name) for m in marks] == [
            (c, n) for c in range(2) for n in profiling.MARKS]
        t = [m.t_ns for m in marks]
        assert t == sorted(t)
        for c in range(2):
            assert t[4 * c] < t[4 * c + 1] < t[4 * c + 2] < t[4 * c + 3]
        _inside_its_dispatch(rec, d, marks)
    replays = [s for s in rec.spans if s.name == "graphs.replay"]
    assert [(s.dispatch, s.label) for s in replays] == [
        (2, "2 cycles"), (3, "2 cycles")]


@pytest.mark.parametrize("on", [True, False], ids=["traced", "untraced"])
def test_traced_replay_equals_the_eager_cycles(cuda, on):
    """A graph captured with the trace on holds its marks and still equals
    the eager cycles bit for bit; one captured with it off holds none."""
    from fsrl_torch.utils import profiling
    profiling.enable(on)
    try:
        g, e = _onpolicy(fuse_iters=2), _onpolicy()
        for _ in range(3):
            g._run_iter()
        for _ in range(6):
            e.cycle()
    finally:
        profiling.enable(True)
    assert g.graph.captured.marks == (8 if on else 0)
    _same(g, e)


def test_chunk_graph_dispatch_marks_and_spans(cuda):
    """Off-policy with chunk graphs: each dispatch's four eager marks
    inside its span, its ``collector.collect`` span, and a
    ``graphs.replay`` span for each chunk graph it replays."""
    from fsrl_torch.agent import SACLagAgent
    from fsrl_torch.trainer import OffpolicyTrainer
    from fsrl_torch.utils import profiling
    profiling.enable(True)
    profiling.reset()
    agent = SACLagAgent("SafetyBallCircle-v0", cost_limit=10.0,
                        batch_size=64)
    tr = OffpolicyTrainer(agent.algo, agent.env, None, n_envs=4,
                          steps_per_collect=25, buffer_size=100,
                          update_per_step=0.2, update_chunk=8, seed=0,
                          verbose=False, state=agent.state)
    for _ in range(4):
        tr._run_iter()
    rec = profiling.record()
    assert rec.dispatches() == [1, 2, 3, 4]
    for d in (1, 2, 3, 4):
        marks = _marks_of(rec, d)
        assert [m.name for m in marks] == list(profiling.MARKS)
        _inside_its_dispatch(rec, d, marks)
        names = [s.name for s in rec.spans if s.dispatch == d]
        assert names.count("collector.collect") == 1
    # the first dispatch warms both graphs up eagerly; then 8, 8 and 4
    # grad steps replay (the 4-step graph's first replay in dispatch 2)
    assert [len([s for s in rec.spans if s.dispatch == d
                 and s.name == "graphs.replay"]) for d in (1, 2, 3, 4)] == [
        1, 3, 3, 3]
