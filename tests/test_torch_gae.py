"""GAE: the port's plain version (kernel K1's reference) and its kernel
wrapper on CPU tensors, against JAX's sequential scan and the Pallas kernel
in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import n

from fsrl_tpu.ops.gae import gae_advantages as j_gae
from fsrl_tpu.ops.pallas_gae import gae_advantages_pallas
from fsrl_torch.ops import kernels
from fsrl_torch.ops.gae import gae_advantages
from fsrl_torch.ops.gae_kernel import (STRIP, TIME_TILE,
                                       gae_advantages_fused)

torch.set_num_threads(1)


def _inputs(T, N, K, seed):
    rng = np.random.default_rng(seed)
    m, v, vn = (rng.normal(size=(T, N, K)).astype(np.float32)
                for _ in range(3))
    end = rng.random((T, N)) < 0.15
    return m, v, vn, end


# B = N*K is not a multiple of 128, so the Pallas wrapper pads
@pytest.mark.parametrize("T,N,K", [(37, 45, 2), (16, 100, 3), (64, 5, 2)])
def test_gae_matches_jax_scan_and_pallas(T, N, K):
    m, v, vn, end = _inputs(T, N, K, T)
    ja, jr = j_gae(*(jnp.asarray(x) for x in (m, v, vn, end)), 0.99, 0.95)
    pa, pr = gae_advantages_pallas(*(jnp.asarray(x) for x in (m, v, vn, end)),
                                   0.99, 0.95, interpret=True)
    args = [torch.from_numpy(x) for x in (m, v, vn, end)]
    ta, tr = gae_advantages(*args, 0.99, 0.95)
    before = sum(kernels.LAUNCHES.values())
    fa, fr = gae_advantages_fused(*args, 0.99, 0.95)
    # a CPU tensor takes the plain version and launches nothing
    assert sum(kernels.LAUNCHES.values()) == before
    # the same recurrence in the same order, but XLA may contract a step's
    # multiply-add into an FMA (its own scan and Pallas kernel differ here
    # too), rounding once instead of twice: a few f32 ulps of the largest
    # advantage, so atol is 1e-6 of it
    atol = 1e-6 * max(1.0, float(np.abs(np.asarray(ja)).max()))
    for ours in ((ta, tr), (fa, fr)):
        for a, b in ((ours[0], ja), (ours[1], jr), (ours[0], pa),
                     (ours[1], pr)):
            np.testing.assert_allclose(n(a), np.asarray(b), rtol=1e-6,
                                       atol=atol)


def test_gae_end_flag_breaks_the_chain():
    m, v, vn, end = _inputs(8, 3, 2, 0)
    end[:] = True
    a, r = gae_advantages(*(torch.from_numpy(x) for x in (m, v, vn, end)),
                          0.9, 0.5)
    np.testing.assert_allclose(n(a), m + 0.9 * vn - v, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(n(r), n(a) + v, rtol=1e-6, atol=1e-6)


# the kernel walks time in tiles of TIME_TILE steps and columns in strips of
# STRIP: T above one tile (and no multiple of it), N*K no multiple of the
# strip, with N*K a multiple of 4 (16-byte accesses) and not (4-byte)
@pytest.mark.parametrize("T,N,K", [(TIME_TILE + 36, 37, 3),
                                   (2 * TIME_TILE + 1, STRIP + 2, 2),
                                   (TIME_TILE + 1, 2 * STRIP + 3, 1)])
def test_gae_beyond_one_time_tile_and_strip(T, N, K):
    assert T > TIME_TILE and (N * K) % STRIP != 0
    m, v, vn, end = _inputs(T, N, K, T + N)
    ja, jr = j_gae(*(jnp.asarray(x) for x in (m, v, vn, end)), 0.99, 0.95)
    pa, pr = gae_advantages_pallas(*(jnp.asarray(x) for x in (m, v, vn, end)),
                                   0.99, 0.95, interpret=True)
    fa, fr = gae_advantages_fused(*(torch.from_numpy(x)
                                    for x in (m, v, vn, end)), 0.99, 0.95)
    # as above: XLA may contract a step's multiply-add, the port rounds twice
    atol = 1e-6 * max(1.0, float(np.abs(np.asarray(ja)).max()))
    for a, b in ((fa, ja), (fr, jr), (fa, pa), (fr, pr)):
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=1e-6, atol=atol)
