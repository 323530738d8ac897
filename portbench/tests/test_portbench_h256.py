"""The benchmark code of the hidden (256, 256) cell: the rollout kernel's
FLOP arithmetic, the readers of the two kernels' roofline shares on
hand-made profiles, and the look-ahead driver against a program whose
first dispatch holds every update the check reads."""

import pytest
import torch

from fsrl_torch.utils import profiling
from portbench import harness
from portbench.drivers import onpolicy, onpolicy_lookahead
from portbench.flops import k2, ppo_lag, rollout
from portbench.tests.test_portbench_program_trace import _rec, _record

BENCH = harness.load_json(harness.REPO / "BENCHMARK.json")
PEAKS = harness.load_json(harness.REPO / "portbench" / "peaks.json")
H256 = harness.cell_files(BENCH, "ppol-h256-f32-fuse2")
H128 = harness.cell_files(BENCH, "ppol-f32-fuse8")
READERS = ("kernels.k2_any_roofline_pct", "kernels.rollout_roofline_pct")
US = 1e-6


def test_the_rollout_kernels_flops_are_perf_mds():
    assert rollout.flops(4096, 64, 9, 128, 128, 2) / 1e9 == \
        pytest.approx(9.33, abs=0.005)
    assert rollout.flops(4096, 64, 9, 256, 256, 2) / 1e9 == \
        pytest.approx(35.8, abs=0.05)
    # bound by the products at both widths: 0.139 and 0.535 ms
    for files, ms in ((H128, 0.1392), (H256, 0.5349)):
        assert 1e3 * rollout.bound_s(files["config"], files["traffic"],
                                     PEAKS) == pytest.approx(ms, abs=1e-4)


def _records(files, kernels):
    return dict(config=files["config"], traffic=files["traffic"],
                peaks=PEAKS, window=dict(dispatches=3, seconds=1.0),
                profile=dict(kernels=kernels, busy_s=1.0, window_s=1.0))


@pytest.mark.parametrize("name", READERS)
def test_a_reader_finds_nothing_without_a_profile(name):
    rec = dict(_records(H256, {}), profile=None)
    assert harness.load_reader(name)(rec) is None


ROW = ("void ppo_any::(anonymous namespace)::row_kernel<false, false>"
       "(ppo_any::(anonymous namespace)::RowArgs)")
WGRAD = ("void ppo_any::(anonymous namespace)::wgrad_kernel<false>"
         "(ppo_any::(anonymous namespace)::WArgs)")
REDUCE = ("void ppo_any::(anonymous namespace)::reduce_kernel"
          "(ppo_any::(anonymous namespace)::RedArgs)")
ATEN_REDUCE = ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp"
               "<float, at::native::func_wrapper_t<float, at::native::"
               "sum_functor<float, float, float>::operator()>, unsigned int,"
               " float, 4> >(at::native::ReduceOp<float>)")


def test_k2_any_sums_its_three_launches_a_call():
    """Two calls: 1.0 + 0.5 + 0.1 ms and 1.2 + 0.5 + 0.1 ms, a mean of
    1.7 ms a call; ATen's reduce_kernel and the tuned K2 do not count."""
    kern = {ROW: [1.0e-3, 1.2e-3], WGRAD: [0.5e-3, 0.5e-3],
            REDUCE: [0.1e-3, 0.1e-3], ATEN_REDUCE: [5e-3] * 7,
            "void ppo::(anonymous namespace)::ppo_grad_f32_kernel<0, 4>()":
            [9e-3]}
    cfg, tr = H256["config"], H256["traffic"]
    bound = k2.bound_s(*ppo_lag.shapes(cfg), ppo_lag.minibatch_rows(cfg, tr),
                       False, PEAKS)
    got = harness.load_reader(READERS[0])(_records(H256, kern))
    assert got == pytest.approx(100 * bound / 1.7e-3)
    # the bound at (9, 256, 256, 2, 2) and 32,768 rows: PERF.md's 0.2428 ms
    assert 1e3 * bound == pytest.approx(0.2428, abs=1e-4)
    assert harness.load_reader(READERS[0])(
        _records(H256, {ATEN_REDUCE: [1e-3]})) is None


H128_KERNEL = ("void (anonymous namespace)::rollout_kernel<0, 1, 16>"
               "(RolloutArgs, RolloutConsts)")
H256_KERNEL = ("void (anonymous namespace)::rollout_kernel_h256<0, 1>"
               "(RolloutArgs, RolloutConsts)")


@pytest.mark.parametrize("files,own,other", [
    (H128, H128_KERNEL, H256_KERNEL), (H256, H256_KERNEL, H128_KERNEL)])
def test_the_rollout_share_reads_its_widths_kernel(files, own, other):
    kern = {own: [400 * US, 600 * US], other: [9.0]}
    bound = rollout.bound_s(files["config"], files["traffic"], PEAKS)
    assert harness.load_reader(READERS[1])(_records(files, kern)) == \
        pytest.approx(100 * bound / 500e-6)


def test_the_rollout_share_of_a_loop_reads_the_rollouts_marks(monkeypatch):
    """Without a rollout kernel in the slice, the rollout's device time a
    cycle from the program's marks: 30 ms in the hand-made record."""
    monkeypatch.setattr(profiling, "record", _record)
    rec = dict(_records(H256, {"void at::native::some_kernel()": [1e-3]}),
               window=_rec()["window"])
    bound = rollout.bound_s(H256["config"], H256["traffic"], PEAKS)
    assert harness.load_reader(READERS[1])(rec) == \
        pytest.approx(100 * bound / 30e-3)


def test_the_look_ahead_reads_the_programs_first_updates():
    """At ``fuse_iters`` 2 the look-ahead driver reads what the plain
    driver reads of a program that fuses 4 cycles, bit for bit, and its
    replay equals its first dispatch."""
    torch.set_num_threads(2)
    cfg = H256["config"]

    def readings(mod, fuse):
        tr = dict(n_envs=32, steps_per_collect=8, fuse_iters=fuse,
                  dispatch_mode="", profile_dispatches=1)
        prog = mod.Program(cfg, tr, 7, "cpu")
        prog.check_dispatches()
        return prog.readings

    a, b = readings(onpolicy_lookahead, 2), readings(onpolicy, 4)
    assert a["loss"] == b["loss"] and a["multiplier"] == b["multiplier"]
    for key in ("grad", "params", "params0"):
        assert a[key].keys() == b[key].keys()
        assert all(torch.equal(a[key][k], b[key][k]) for k in a[key])
    assert a["replay_differs"] == [] == b["replay_differs"]
