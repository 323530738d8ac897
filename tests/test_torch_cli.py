"""The port's per-algorithm command lines
(``fsrl_torch/examples/mlp/{train,eval}_*_agent.py`` over ``common.py``)
and its demo yaml, against the JAX package's ``examples/``."""

import dataclasses
import os
import runpy
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import yaml

from fsrl_torch.config.cli import parse_config
from fsrl_torch.config.configs import PPOLagCfg

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
ALGOS = ("ppol", "focops", "trpol", "cpo", "ddpgl", "sacl", "cvpo")
SMALL = ["--device", "cpu", "--epochs", "1", "--n_envs", "2",
         "--episode_per_test", "1", "--verbose", "false"]


def _python_m(module: str, *args: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    return subprocess.run([sys.executable, "-m", module, *args], env=env,
                          capture_output=True, text=True, timeout=240)


def test_train_then_eval_ppol(tmp_path):
    """``train_ppol_agent`` writes the run directory; ``eval_ppol_agent
    --path`` rebuilds the agent from it and evaluates."""
    res = _python_m("fsrl_torch.examples.mlp.train_ppol_agent", *SMALL,
                    "--step_per_epoch", "64", "--steps_per_collect", "32",
                    "--save_interval", "1", "--logdir", str(tmp_path))
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    assert "final eval" in res.stdout
    (run,) = tmp_path.glob("*/*/*")
    assert (run / "checkpoint" / "model.pt").is_file()
    assert (run / "checkpoint" / "model_best.pt").is_file()
    config = yaml.safe_load((run / "config.yaml").read_text())
    assert config["task"] == "SafetyCarCircle-v0"
    assert config["n_envs"] == 2 and config["use_mesh"] is False
    res = _python_m("fsrl_torch.examples.mlp.eval_ppol_agent", "--path",
                    str(run), "--device", "cpu", "--eval_episodes", "2")
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    assert "Eval reward" in res.stdout


def test_train_sacl_agent_takes_a_tiny_run(tmp_path):
    """The off-policy command line: one epoch of one collect."""
    from fsrl_torch.examples.mlp.train_sacl_agent import main
    info = main(SMALL + ["--task", "SafetyBallCircle-v0",
                         "--step_per_epoch", "64", "--steps_per_collect",
                         "32", "--batch_size", "16", "--update_per_step",
                         "0.05", "--logdir", str(tmp_path)])
    assert info["epoch"] == 1 and info["env_step"] == 64
    (run,) = tmp_path.glob("*/*/*")
    assert (run / "checkpoint" / "model_best.pt").is_file()


def test_use_mesh_without_torchrun_is_refused(tmp_path, monkeypatch):
    from fsrl_torch.examples.mlp.train_ppol_agent import main
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        main(["--use_mesh", "true", "--device", "cpu", "--logdir",
              str(tmp_path)])


@pytest.mark.parametrize("kind", ["train", "eval"])
@pytest.mark.parametrize("algo", ALGOS)
def test_every_command_line_runs_as_a_module(algo, kind, monkeypatch,
                                             capsys):
    """Each of the 14 modules parses its flags when run as ``__main__``
    (``--help`` lists them and exits 0)."""
    module = f"fsrl_torch.examples.mlp.{kind}_{algo}_agent"
    monkeypatch.setattr(sys, "argv", [module, "--help"])
    # run fresh as __main__, not as a module an earlier test imported
    monkeypatch.delitem(sys.modules, module, raising=False)
    with pytest.raises(SystemExit) as exit_:
        runpy.run_module(module, run_name="__main__")
    assert exit_.value.code == 0
    out = capsys.readouterr().out
    assert ("--use_mesh" in out and "--task" in out) if kind == "train" \
        else "--path" in out


def test_demo_yaml_matches_the_jax_example():
    """The port's copy of the demo yaml sets the same fields to the same
    values as the JAX package's, read by each package's own parser."""
    from fsrl_tpu.config.cli import parse_config as j_parse_config
    from fsrl_tpu.config.configs import PPOLagCfg as JPPOLagCfg
    name = "demo_ppol_cfg.yaml"
    ours = ROOT / "fsrl_torch" / "examples" / "yaml_cfgs" / name
    theirs = ROOT / "examples" / "yaml_cfgs" / name
    raw = yaml.safe_load(ours.read_text())
    assert raw == yaml.safe_load(theirs.read_text())
    cfg = dataclasses.asdict(parse_config(PPOLagCfg, ["--config",
                                                      str(ours)]))
    jcfg = dataclasses.asdict(j_parse_config(JPPOLagCfg, ["--config",
                                                          str(theirs)]))
    for k in raw:
        assert cfg[k] == jcfg[k], k
    assert cfg["lagrangian_pid"] == (0.05, 0.0005, 0.1)
    assert cfg["steps_per_collect"] == 500 and cfg["lr"] == 0.0005
