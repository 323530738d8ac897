"""The frozen FLOP and byte arithmetic against hand counts."""

import pytest

from portbench import harness
from portbench.flops import k1, k2, ppo_lag, sac_lag

PEAKS = harness.load_json(harness.REPO / "portbench" / "peaks.json")


def test_k2_at_the_cells_shape_is_the_chip_scripts_bound():
    # chip_smoke.py's arithmetic at (D, H1, H2, A, K, rows) = (9, 128,
    # 128, 2, 2, 32768), written out by hand: three towers' products, the
    # heads' (2 + 1 + 1 outputs), three TF32 passes, FP32 heads
    mm = 32768 * 3 * (6 * 128 * 128 + 4 * 9 * 128)
    heads = 32768 * 6 * 128 * 4
    assert k2.flops(9, 128, 128, 2, 2, 32768) == (mm, heads)
    ops_s = 3 * mm / 495e12 + heads / 67e12
    assert k2.bound_s(9, 128, 128, 2, 2, 32768, False, PEAKS) == \
        pytest.approx(ops_s, rel=1e-12)
    assert k2.bound_s(9, 128, 128, 2, 2, 32768, False, PEAKS) * 1e3 == \
        pytest.approx(0.0628, abs=5e-5)          # PERF.md's K2 f32 bound


def test_k2_parameter_count_and_bytes():
    from fsrl_torch.ops.fused_ppo_grad import GradLayout
    for d, h1, h2, a, k in ((9, 128, 128, 2, 2), (3, 4, 5, 2, 1)):
        assert k2.n_params(d, h1, h2, a, k) == \
            GradLayout(D=d, H=h1, A=a, K=k, H2=h2).size
    assert k2.nbytes(3, 4, 5, 2, 1, 10) == 4 * (10 * (3 + 2 + 1 + 2)
                                                 + 2 * k2.n_params(
                                                     3, 4, 5, 2, 1) + 8)


def test_k1_is_bound_by_bytes():
    assert k1.bound_s(64, 4096, 2, PEAKS) == pytest.approx(
        (20 * 64 * 4096 * 2 + 64 * 4096) / 3.35e12)


def tiny_ppo():
    cfg = {"task": {"obs_dim": 3, "act_dim": 2, "num_costs": 1},
           "algorithm_kwargs": {"hidden_sizes": [4, 5], "repeat": 2,
                                "n_minibatches": 2}}
    return cfg, {"n_envs": 2, "steps_per_collect": 4, "fuse_iters": 3}


def test_ppo_lag_cycle_by_hand():
    cfg, traffic = tiny_ppo()
    # 8 rows, tiles of 1 row, 2 minibatches of 4 rows, 2 epochs
    assert ppo_lag.minibatch_rows(cfg, traffic) == 4
    policy = 8 * 2 * (3 * 4 + 4 * 5 + 5 * 2)
    critics = 10 * 2 * 2 * (3 * 4 + 4 * 5 + 5)
    per_row = 3 * (6 * 4 * 5 + 4 * 3 * 4) + 6 * 5 * (2 + 1 + 1)
    update = 4 * 4 * per_row
    assert ppo_lag.cycle_flops(cfg, traffic) == policy + critics + update
    assert ppo_lag.dispatch_flops(cfg, traffic) == 3 * (policy + critics
                                                        + update)


def test_ppo_lag_minibatch_rows_at_the_cells():
    cfg = {"algorithm_kwargs": {"n_minibatches": 8}}
    for n, t in ((4096, 64), (16384, 16)):
        assert ppo_lag.minibatch_rows(
            cfg, {"n_envs": n, "steps_per_collect": t}) == 32768


def test_sac_lag_by_hand():
    cfg = {"task": {"obs_dim": 3, "act_dim": 2, "num_costs": 1},
           "algorithm_kwargs": {"hidden_sizes": [4, 5], "batch_size": 6}}
    # a row: policy forward 2 (12 + 20 + 20) = 104, its input gradients
    # past layer 1 2 (20 + 20) = 80; four Q towers forward 8 (20 + 20 +
    # 5) = 360, of which past layer 1 8 (20 + 5) = 200
    target = 104 + 360
    critic = 360 + 360 + 200
    actor = 104 + 360 + 360 + 104 + 80
    assert sac_lag.grad_step_flops(cfg) == 6 * (target + critic + actor)
    assert sac_lag.grad_step_flops(cfg) == 6 * 2392
    traffic = {"n_envs": 2, "steps_per_collect": 5, "update_per_step": 0.4,
               "fuse_iters": 1}
    # 10 rows of the policy, round(0.4 * 10) = 4 grad steps
    assert sac_lag.dispatch_flops(cfg, traffic) == 10 * 104 + 4 * 6 * 2392
