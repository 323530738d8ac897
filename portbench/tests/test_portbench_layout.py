"""Every piece of a cell is a file found by its name in BENCHMARK.json."""

import importlib
import json

import pytest
import torch

from portbench import harness

BENCH = harness.load_json(harness.REPO / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_files_by_name(cell):
    files = harness.cell_files(BENCH, cell)
    cfg = files["config"]
    assert cfg["name"] == files["cell"]["config"]
    for key in ("driver", "algorithm"):
        assert cfg[key]
    importlib.import_module(f"portbench.drivers.{cfg['driver']}")
    importlib.import_module(f"portbench.reference.{cfg['algorithm']}")
    importlib.import_module(f"portbench.flops.{cfg['algorithm']}")
    from portbench import compare
    names = set(files["limits"]["limits"])
    # a loss, a gradient, a change, the multiplier and the replay, each a
    # number compare.gaps gives
    assert {n.split("_")[0] for n in names} == {
        "loss", "grad", "change", "multiplier", "replay"}
    assert files["limits"]["limits"]["replay_differs"] == 0
    dummy = {"loss": [1.0], "multiplier": [0.5], "grad": {"a": torch.ones(2)},
             "params": {"a": torch.ones(2)}, "params0": {"a": torch.zeros(2)}}
    assert names <= set(compare.gaps(dummy, dummy))
    assert files["traffic"]["n_envs"] > 0


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_each_per_layer_metric_has_its_reader(metric):
    assert callable(harness.load_reader(metric))


def test_a_new_cell_is_a_new_file_and_an_entry(tmp_path, monkeypatch):
    """A cell added as an entry and a traffic and a limits file, with no
    edit to any file already there, is found, and per-layer metrics
    that list other cells skip it."""
    (tmp_path / "traffic").mkdir()
    (tmp_path / "limits").mkdir()
    (tmp_path / "traffic" / "n8-t4-new.json").write_text(
        json.dumps({"n_envs": 8}))
    (tmp_path / "limits" / "new-cell.json").write_text(
        json.dumps({"limits": {"loss_gap": 1.0}}))
    monkeypatch.setattr(harness, "HERE", tmp_path)
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "new-cell",
                               "config": bench["configs"][0]["name"],
                               "traffic": "n8-t4-new", "chips": 1,
                               "why": "x"})
    files = harness.cell_files(bench, "new-cell")
    assert files["traffic"] == {"n_envs": 8}
    monkeypatch.setattr(harness, "HERE", harness.REPO / "portbench")
    seen = []
    monkeypatch.setattr(harness, "load_reader",
                        lambda name: lambda rec: seen.append(name))
    harness.per_layer(bench, "new-cell", {})
    assert seen == [m["name"] for m in bench["per_layer"]
                    if "workloads" not in m]


def test_perf_md_gives_the_bounds_that_benchmark_json_holds():
    """PERF.md's table of end-to-end metrics states each metric's bound as
    BENCHMARK.json has it."""
    text = (harness.REPO / "PERF.md").read_text()
    section = text.split("\n## 2.")[1].split("\n## 3.")[0]
    rows = {}
    for line in section.splitlines():
        cols = [c.strip() for c in line.strip().strip("|").split("|")]
        if len(cols) == 4 and cols[0].startswith("`"):
            rows[cols[0].strip("`")] = cols[3]
    for m in BENCH["end_to_end"]:
        assert float(rows[m["name"]]) == m["bound"], m["name"]


def test_a_traced_run_on_the_card_fails_where_a_reader_finds_nothing(
        monkeypatch):
    monkeypatch.setattr(harness, "load_reader", lambda name: lambda r: None)
    cell = CELLS[0]
    assert harness.per_layer(BENCH, cell, {}) == {}
    with pytest.raises(RuntimeError, match="found nothing"):
        harness.per_layer(BENCH, cell, {}, required=True)
