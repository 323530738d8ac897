"""A run on the CPU at a tiny size (the harness's look for a card
skipped): the result's shape, the import check, and the faults that make
``correct`` false."""

import ast
import json
import subprocess
import sys
import time
import types

import pytest

from portbench import harness
from portbench.tests.conftest import TINY

BENCH = harness.load_json(harness.REPO / "BENCHMARK.json")
CELL_OF = {}
for w in BENCH["workloads"]:
    CELL_OF.setdefault(w["config"], w["name"])


def tiny_run(config, fault=None, trace=False):
    return harness.run_cell(BENCH, CELL_OF[config], 2 ** 31 + 12345, 0.5,
                            trace, time.perf_counter(), device="cpu",
                            traffic=TINY[config], fault=fault)


@pytest.mark.parametrize("config", sorted(TINY))
def test_result_line_shape(config):
    out = tiny_run(config)
    assert list(out)[-1] == "checked"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in out
    assert out["correct"] is True
    assert set(out["metrics"]) == {m["name"] for m in BENCH["end_to_end"]}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] >= 0
    for k, v in out["checked"].items():
        assert v["value"] <= v["limit"], k
    json.dumps(out)


@pytest.mark.parametrize("config", sorted(TINY))
def test_traced_run_reports_what_the_cpu_can_read(config):
    """Without the card's trace only the span readers find something."""
    out = tiny_run(config, trace=True)
    spans = {"collector.collect_ms", "update.grad_step_ms"}
    want = {"step.mfu_pct"} | (spans if TINY[config].get("spans") else set())
    assert set(out["metrics"]) == want


@pytest.mark.parametrize("fault", ["frozen", "half_batch", "frozen_replay",
                                   "zero_cost"])
@pytest.mark.parametrize("config", sorted(TINY))
def test_a_broken_timed_path_is_not_correct(config, fault):
    """Each step returning its state unchanged, half of each batch left
    out, a dispatch after the first that returns its state unchanged, and
    the multiplier's step blind to the cost, fail the comparison."""
    out = tiny_run(config, fault)
    assert out["correct"] is False
    if fault == "frozen_replay":
        assert out["checked"]["replay_differs"]["value"] > 0
    if fault == "zero_cost":
        assert out["checked"]["multiplier_gap"]["value"] == 1.0


def test_import_check_compares_whole_top_level_names(monkeypatch):
    for name in ("jax", "jaxlib.xla", "flax.linen", "optax", "fsrl_tpu.ops"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["flax", "fsrl_tpu", "jax",
                                           "jaxlib", "optax"]


def test_no_forbidden_module_loaded_by_a_run():
    """A tiny run loads none of JAX or the JAX package (run alone, in a
    fresh process)."""
    code = ("import sys, time; sys.path.insert(0, '.');"
            "from portbench import harness;"
            "from portbench.tests.conftest import TINY;"
            "b = harness.load_json(harness.REPO / 'BENCHMARK.json');"
            "harness.run_cell(b, 'ppol-f32-fuse8', 1, 0.2, False,"
            " time.perf_counter(), device='cpu',"
            " traffic=TINY['ppol-carcircle-f32']);"
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_sources_import_nothing_forbidden():
    for path in (harness.REPO / "portbench").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom)
                     and node.module else [])
            for n in names:
                assert n.split(".")[0] not in harness.FORBIDDEN, path


def test_without_a_card_the_command_prints_no_result(monkeypatch):
    """No CUDA device: a non-zero exit and nothing on standard output."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "ppol-f32-fuse8", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=harness.REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
