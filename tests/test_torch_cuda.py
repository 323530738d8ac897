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
    from fsrl_torch.ops.fused_ppo_grad import (policy_logp, ppo_grad_plain,
                                               ppo_grad_rows)
    B, D, A, K = 1000, 9, 2, 2     # a ragged last chunk of rows
    algo = PPOLag(D, A, device=cuda)
    state = algo.init(seed=0)
    g = torch.Generator(device=cuda).manual_seed(1)
    obs = torch.randn(B, D, device=cuda, generator=g)
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
    gp, ap = ppo_grad_plain(*args, eps_clip=0.2, vf_coef=0.25, bf16=bf16)
    # f32: summation order only; bf16: an operand may round to the
    # neighbouring bf16 value when its f32 sum came out in another order
    tol = 1e-2 if bf16 else 1e-4
    for name, x in algo.grad_layout.views(gk).items():
        ref = algo.grad_layout.views(gp)[name]
        assert float((x - ref).abs().max()) <= tol * float(
            ref.abs().max()) + 1e-7, name
    torch.testing.assert_close(ak, ap, rtol=tol, atol=1e-5)
