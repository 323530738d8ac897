"""The port's real-physics runners (``fsrl_torch.examples.run_velocity``
and ``run_pointgoal``) against the JAX package's
``benchmarks/run_velocity.py`` and ``run_pointgoal.py`` on the CPU, at a
tiny budget on the real MuJoCo envs: the configs' defaults, the result
JSON's keys and file names (those of the committed results), the summary
table, the skip of an existing PointGoal result, the refusal of
``benchmarks/`` and of an unknown algorithm key."""

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import pytest
import torch

pytest.importorskip("gymnasium")
pytest.importorskip("mujoco")

from fsrl_torch.examples import run_pointgoal, run_velocity  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
VEL = ROOT / "benchmarks" / "results_velocity"
PG = ROOT / "benchmarks" / "results_pointgoal"
TINY_VEL = ["--device", "cpu", "--seeds", "0", "--budget", "200",
            "--off_budget", "200", "--step_per_epoch", "200", "--n_envs",
            "2", "--steps_per_collect", "100", "--off_n_envs", "2",
            "--off_steps_per_collect", "100", "--episode_per_test", "1"]
TINY_PG = ["--device", "cpu", "--seeds", "0", "--budget", "200",
           "--step_per_epoch", "200", "--n_envs", "2",
           "--steps_per_collect", "100", "--episode_per_test", "1"]


def _jax_module(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod      # its dataclass looks itself up there
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,port_cfg,jax_cfg", [
    ("run_velocity", run_velocity.VelCurveCfg, "VelCurveCfg"),
    ("run_pointgoal", run_pointgoal.PGCfg, "PGCfg")])
def test_config_defaults_are_jax(name, port_cfg, jax_cfg):
    jc = getattr(_jax_module(name), jax_cfg)()
    want = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)}
    got = {f.name: getattr(port_cfg(), f.name)
           for f in dataclasses.fields(port_cfg)}
    # the port's own: where it writes (never benchmarks/) and its device
    assert got.pop("outdir").startswith("logs/") and got.pop("device") == \
        "cuda"
    want.pop("outdir")
    assert got == want


def _keys(path):
    with open(path) as f:
        return set(json.load(f))


def test_velocity_runner_writes_the_jax_results(tmp_path):
    rows = run_velocity.main(TINY_VEL + [
        "--algos", "ppol,sacl", "--pid", "0.1,0.003,0.1", "--outdir",
        str(tmp_path)])
    task = "SafetyHalfCheetahVelocity-v1"
    names = sorted(p.name for p in tmp_path.glob("*.json"))
    # the -pid tag on ppol only, as the committed results name them
    assert names == [f"{task}-ppol-pid0.1_0.003_0.1-s0.json",
                     f"{task}-sacl-s0.json"]
    assert all((VEL / n).exists() for n in names)
    for n in names:
        assert _keys(tmp_path / n) == _keys(VEL / n)
    assert [r["algo"] for r in rows] == ["ppol", "sacl"]
    assert all(r["physics"] == "mujoco" and r["budget"] == 200
               and len(r["curve"]["reward"]) == 1 for r in rows)
    summary = (tmp_path / f"summary-{task}.md").read_text()
    assert "| ppol (pid-retune) | 0 | 200 |" in summary
    assert "| sacl | 0 | 200 |" in summary


def test_pointgoal_runner_writes_the_jax_results_and_skips(tmp_path):
    rows = run_pointgoal.main(TINY_PG + ["--algos", "ppol", "--outdir",
                                         str(tmp_path)])
    name = "SafetyPointGoal1-MJ-v0-ppol-s0.json"
    assert [p.name for p in tmp_path.glob("*.json")] == [name]
    assert _keys(tmp_path / name) == _keys(PG / name)
    assert rows[0]["task"] == "SafetyPointGoal1-MJ-v0"
    assert (tmp_path / "summary-SafetyPointGoal1-MJ-v0.md").is_file()
    # an existing result is kept, not run again
    before = (tmp_path / name).read_text()
    assert run_pointgoal.main(TINY_PG + ["--algos", "ppol", "--outdir",
                                         str(tmp_path)]) == []
    assert (tmp_path / name).read_text() == before


@pytest.mark.parametrize("runner,tiny", [(run_velocity, TINY_VEL),
                                         (run_pointgoal, TINY_PG)])
def test_runners_refuse_benchmarks_and_unknown_algos(tmp_path, runner,
                                                     tiny):
    with pytest.raises(ValueError, match="benchmarks"):
        runner.main(tiny + ["--algos", "ppol", "--outdir",
                            str(ROOT / "benchmarks" / "x")])
    assert not (ROOT / "benchmarks" / "x").exists()
    # the JAX velocity runner trains CVPO for a key it does not know
    with pytest.raises(KeyError, match="unknown algos"):
        runner.main(tiny + ["--algos", "ppol,bogus", "--outdir",
                            str(tmp_path)])
    assert not list(tmp_path.iterdir())
