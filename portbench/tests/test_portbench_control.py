"""On the card: the control (the reference computed with TF32 products,
put in the program's place) fails the comparison; and a fault that only a
replayed graph has fails it too (at sizes a test run holds;
``portbench/readings.py`` reads the control at the cells' own sizes)."""

import time

import pytest
import torch

from portbench import compare, harness
from portbench.drivers.common import CHECKED_STEPS

BENCH = harness.load_json(harness.REPO / "BENCHMARK.json")


# the cells' traffic at a size a test run holds
SMALLER = {"ppol-f32-fuse8": dict(n_envs=1024), "sacl-chunk256": {}}
# smaller still, every graph of the cell's kind replayed
REPLAYED = {
    "ppol-f32-fuse8": dict(n_envs=1024, fuse_iters=4,
                           dispatch_mode="graph of 4 cycles"),
    "sacl-chunk256": dict(n_envs=8, steps_per_collect=25, buffer_size=400,
                          update_chunk=16, fill_collects=2,
                          dispatch_mode="eager collect; grad steps in "
                                        "graphs of 8, 16"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALLER))
def test_tf32_control_is_not_correct(card, cell):
    import importlib
    files = harness.cell_files(BENCH, cell)
    cfg, limits = files["config"], files["limits"]["limits"]
    traffic = dict(files["traffic"], **SMALLER[cell])
    driver = importlib.import_module(f"portbench.drivers.{cfg['driver']}")
    ref_mod = importlib.import_module(
        f"portbench.reference.{cfg['algorithm']}")
    for seed in (1, 2, 3):
        weights = driver.make_weights(cfg, seed, card)
        ref = ref_mod.run(cfg, traffic, weights, seed, card,
                          checked=CHECKED_STEPS)
        control = ref_mod.run(cfg, traffic, weights, seed, card,
                              checked=CHECKED_STEPS, tf32=True)
        start = dict(weights, log_alpha=torch.zeros((), device=card))
        gaps = compare.gaps(dict(control, params0=start), ref)
        assert not compare.judge(gaps, limits), gaps


def _skip_outside_a_capture(assign):
    def skipped(dst, src):
        if torch.cuda.is_current_stream_capturing():
            assign(dst, src)
    return skipped


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [None, "no_replay", "stale_inputs"])
@pytest.mark.parametrize("cell", sorted(REPLAYED))
def test_a_replay_only_fault_is_not_correct(card, cell, fault, monkeypatch):
    """A run whose graphs replay what the eager first dispatch computes is
    correct; one whose replays do nothing, or read the state their graph
    last wrote instead of the one they are given (the off-policy chunk
    graphs, which are handed a new multiplier every collect), is not."""
    from fsrl_torch.trainer import graphs

    if fault == "stale_inputs" and cell.startswith("ppol"):
        pytest.skip("the fused on-policy graph is always handed its own "
                    "inputs: nothing to copy in")
    if fault == "no_replay":
        monkeypatch.setattr(torch.cuda.CUDAGraph, "replay", lambda g: None)
    elif fault == "stale_inputs":
        monkeypatch.setattr(graphs, "assign",
                            _skip_outside_a_capture(graphs.assign))
    traffic = dict(harness.cell_files(BENCH, cell)["traffic"],
                   **REPLAYED[cell])
    out = harness.run_cell(BENCH, cell, 2 ** 31 + 99, 1.0, False,
                           time.perf_counter(), device=card,
                           traffic=traffic)
    differs = out["checked"]["replay_differs"]["value"]
    if fault is None:
        assert out["correct"] is True and differs == 0, out["checked"]
    else:
        assert out["correct"] is False and differs > 0, out["checked"]
