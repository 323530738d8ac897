"""The port's PPO-Lag agent gates (the torch twins of
``tests/test_all_agents.py``: same task, budget and thresholds) on the CPU,
and the port's rules: CUDA unless the CPU is asked for, no JAX import, no
kernel launch on CPU tensors."""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from fsrl_torch.agent import PPOLagAgent
from fsrl_torch.data.collector import make_rollout_fn
from fsrl_torch.ops import kernels

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TASK = "SafetyBallRun-v0"


def test_ppo_lag_learns_unconstrained():
    kernels.reset_launch_counts()
    agent = PPOLagAgent(TASK, cost_limit=9999.0, seed=0, device="cpu")
    assert agent.algo.use_grad_kernel
    info = agent.learn(epochs=8, step_per_epoch=5000, n_envs=10,
                       steps_per_collect=500, episode_per_test=4,
                       reward_threshold=300.0)
    assert info["best_reward"] > 300.0, info
    rew, _, _ = agent.evaluate(n_episodes=4)
    assert rew > 250.0, rew
    # the CPU path ran the plain versions: no kernel launched or built
    assert sum(kernels.LAUNCHES.values()) == 0
    assert kernels.library.cache_info().currsize == 0


def test_ppo_lag_respects_constraint():
    agent = PPOLagAgent(TASK, cost_limit=25.0, seed=0, device="cpu")
    info = agent.learn(epochs=6, step_per_epoch=10000, n_envs=10,
                       steps_per_collect=500, episode_per_test=10)
    rew, _, cost = agent.evaluate(n_episodes=10)
    assert rew > 100.0, info
    assert cost <= 1.2 * 25.0, cost


def test_agent_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        PPOLagAgent(TASK)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_rollout_fn(None, None, 1)


def test_chip_smoke_refuses_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    for where in (ROOT, tmp_path):
        script = where / "chip_smoke.py"
        if where is tmp_path:
            shutil.copy(ROOT / "chip_smoke.py", script)
        out = subprocess.run([sys.executable, str(script)], cwd=where,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_package_data_covers_every_kernel_source():
    """An installed copy must be able to build the kernels: every file
    ``kernels.build`` compiles or hashes, and every file under ``csrc``,
    matches one of the package-data globs of ``pyproject.toml``."""
    import fnmatch
    import tomllib
    cfg = tomllib.loads((ROOT / "pyproject.toml").read_text())
    globs = cfg["tool"]["setuptools"]["package-data"]["fsrl_torch"]
    needed = {f"csrc/{s}" for s in kernels.SOURCES + kernels.HEADERS}
    needed |= {f"csrc/{p.name}" for p in kernels.CSRC.iterdir()}
    assert len(needed) >= 5
    for rel in sorted(needed):
        assert (kernels.PKG / rel).is_file(), rel
        assert any(fnmatch.fnmatch(rel, g) for g in globs), \
            f"{rel} is not packaged by {globs}"
    # what the sources include is among the hashed headers
    for s in kernels.SOURCES + kernels.HEADERS:
        for line in (kernels.CSRC / s).read_text().splitlines():
            if line.startswith('#include "'):
                assert line.split('"')[1] in kernels.HEADERS, (s, line)


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_port_imports_no_jax():
    files = sorted((ROOT / "fsrl_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    assert len(files) > 20
    rel = {str(f.relative_to(ROOT / "fsrl_torch")) for f in files[:-1]}
    assert {"algos/focops.py", "algos/trpo_lag.py", "algos/cpo.py",
            "ops/cg.py", "envs/drone.py", "envs/ant.py",
            "utils/checkpoint.py", "utils/exp_util.py", "config/configs.py",
            "config/cli.py", "examples/run_curves.py",
            "examples/make_summaries.py", "data/hdf5.py",
            "examples/customized/custom_common.py",
            "examples/customized/collect_dataset.py", "trainer/graphs.py",
            "examples/run_velocity.py", "examples/run_pointgoal.py"} <= rel
    for f in files:
        bad = _imports(f) & {"jax", "jaxlib", "flax", "optax", "orbax",
                             "fsrl_tpu"}
        assert not bad, f"{f} imports {bad}"
