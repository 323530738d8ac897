"""PPO-Lagrangian at hidden (256, 256), the benchmark's configuration
``ppol-carcircle-h256-f32``, against its plain reference on the CPU.

The benchmark's harness (``portbench.harness.run_cell``) runs the cell
``ppol-h256-f32-fuse2`` at a tiny traffic: the program (the agent the
configuration names, an ``OnpolicyTrainer`` at ``fuse_iters`` 2) from
seeded random weights, then the reference (plain PyTorch, f32,
``portbench/reference/ppo_lag.py``) from the same weights, each number of
the comparison held to the cell's limit. Planted faults in the program
must fail it.
"""

import time

import pytest
import torch

from portbench import harness

BENCH = harness.load_json(harness.REPO / "BENCHMARK.json")
CELL = "ppol-h256-f32-fuse2"
TINY = {"n_envs": 64, "steps_per_collect": 16, "fuse_iters": 2,
        "dispatch_mode": "", "profile_dispatches": 1}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(fault=None):
    return harness.run_cell(BENCH, CELL, 2 ** 31 + 4242, 0.2, False,
                            time.perf_counter(), device="cpu",
                            traffic=TINY, fault=fault)


def test_the_cell_is_the_configuration_at_hidden_256():
    files = harness.cell_files(BENCH, CELL)
    cfg = files["config"]
    assert cfg["name"] == "ppol-carcircle-h256-f32"
    assert cfg["algorithm_kwargs"]["hidden_sizes"] == [256, 256]
    assert files["traffic"]["fuse_iters"] == 2
    assert files["limits"]["limits"]["replay_differs"] == 0


def test_the_program_matches_the_reference():
    out = _run()
    assert out["correct"] is True
    assert out["checked"]
    for name, v in out["checked"].items():
        assert v["value"] <= v["limit"], name


@pytest.mark.parametrize("fault", ["frozen", "half_batch"])
def test_a_planted_fault_is_not_correct(fault):
    """Each grad step returning its state unchanged, or half of each
    minibatch left out, fails the comparison."""
    assert _run(fault)["correct"] is False
