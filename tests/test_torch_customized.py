"""The hand-assembled loops of ``fsrl_torch.examples.customized`` (ports
of ``examples/customized/*``) on the CPU at a tiny size: every train
script runs, every ``eval_*`` reloads its run directory and reproduces the
trained policy's evaluation, the learning-rate decay equals JAX's schedule
at every count, and the dataset collector sweeps JAX's limits and writes
the layout of JAX's ``TrajectoryBuffer.save``."""

import importlib
import math
from pathlib import Path
from types import SimpleNamespace

import h5py
import numpy as np
import optax
import pytest
import torch

from fsrl_torch.data.traj_buf import TrajectoryBuffer
from fsrl_torch.envs import make
from fsrl_torch.examples.customized import (collect_dataset,
                                            train_ppol_lr_decay)
from fsrl_torch.examples.customized.custom_common import (eval_main,
                                                          evaluate_policy)
from fsrl_tpu.algos.common import per_update_schedule as jax_per_update
from fsrl_tpu.data.traj_buf import TrajectoryBuffer as JTrajectoryBuffer

torch.set_num_threads(1)

PKG = "fsrl_torch.examples.customized"
TINY = ["--device", "cpu", "--total_iters", "2", "--n_envs", "2",
        "--steps_per_collect", "50", "--eval_every", "1"]
OFF = ["--updates_per_collect", "4", "--batch_size", "32"]
# (train script, its eval script, extra flags)
PAIRS = [("train_ppol", "eval_ppol", []),
         ("train_trpol", "eval_trpol", []),
         ("train_ddpgl", "eval_ddpgl", OFF),
         ("train_sac_custom", "eval_sacl", OFF),
         ("train_cvpo", "eval_cvpo", OFF)]


@pytest.mark.parametrize("train,evaluate,extra", PAIRS,
                         ids=[p[0] for p in PAIRS])
def test_train_then_eval_reproduces_the_policy(tmp_path, train, evaluate,
                                               extra):
    tr = importlib.import_module(f"{PKG}.{train}")
    ev = importlib.import_module(f"{PKG}.{evaluate}")
    run_dir, state = tr.main(TINY + extra + ["--logdir", str(tmp_path)])
    run = Path(run_dir)
    assert (run / "config.yaml").is_file()
    assert (run / "checkpoint" / "model.pt").is_file()
    assert "test/reward" in (run / "progress.txt").read_text()
    env = make(tr.CustomCfg.task)
    algo = ev.build(env, {"cost_limit": tr.CustomCfg.cost_limit}, "cpu")
    trained = evaluate_policy(env, algo, state.params, 3, seed=0)
    reloaded = eval_main(ev.build, ["--path", run_dir, "--device", "cpu",
                                    "--eval_episodes", "3"])
    assert reloaded == trained
    assert all(math.isfinite(v) for v in trained)


def test_lr_decay_schedule_matches_jax():
    cfg = train_ppol_lr_decay.LRDecayCfg(total_iters=7, repeat=2,
                                         n_minibatches=3, lr=1e-3)
    port = train_ppol_lr_decay.make_schedule(cfg)
    jax_sched = jax_per_update(
        optax.linear_schedule(init_value=cfg.lr, end_value=0.0,
                              transition_steps=cfg.total_iters),
        grad_steps_per_update=cfg.repeat * cfg.n_minibatches)
    counts = range((cfg.total_iters + 2) * cfg.repeat * cfg.n_minibatches)
    got = np.array([float(port(torch.tensor(c, dtype=torch.int32)))
                    for c in counts], np.float32)
    want = np.array([float(jax_sched(c)) for c in counts], np.float32)
    np.testing.assert_array_equal(got, want)
    assert got[0] == np.float32(cfg.lr) and got[-1] == 0.0


def test_lr_decay_script_logs_the_rate(tmp_path):
    argv = ["--device", "cpu", "--total_iters", "3", "--n_envs", "2",
            "--steps_per_collect", "500", "--eval_every", "1", "--repeat",
            "2", "--n_minibatches", "2", "--logdir", str(tmp_path)]
    run_dir, state = train_ppol_lr_decay.main(argv)
    rows = (Path(run_dir) / "progress.txt").read_text().splitlines()
    head = rows[0].split("\t")
    lrs = [float(r.split("\t")[head.index("train/lr")]) for r in rows[1:]]
    sched = train_ppol_lr_decay.make_schedule(
        train_ppol_lr_decay.LRDecayCfg(total_iters=3, repeat=2,
                                       n_minibatches=2))
    # every collect ends two episodes, and at this size no update stops
    # early on its KL: the rate logged after update u is
    # lr * (1 - u / total_iters)
    assert int(state.update_count) == 3
    assert len(lrs) == 3
    np.testing.assert_allclose(lrs, [5e-4 * (1 - u / 3) for u in (1, 2, 3)],
                               rtol=1e-6)
    assert float(sched(state.gradient_steps)) == pytest.approx(lrs[-1])


def _segment(T: int, N: int, D: int, A: int, M: int, seed: int):
    """A time-major segment of numpy arrays with episodes of 4 steps."""
    rng = np.random.default_rng(seed)
    trunc = np.zeros((T, N), bool)
    trunc[3::4] = True
    return SimpleNamespace(
        obs=rng.standard_normal((T, N, D)).astype(np.float32),
        obs_next=rng.standard_normal((T, N, D)).astype(np.float32),
        act=rng.standard_normal((T, N, A)).astype(np.float32),
        reward=rng.standard_normal((T, N)).astype(np.float32),
        cost=rng.random((T, N, M)).astype(np.float32),
        terminated=rng.random((T, N)) < 0.1, truncated=trunc)


def test_dataset_file_has_jax_layout(tmp_path):
    """The port's file holds JAX's ``TrajectoryBuffer.save`` keys, dtypes,
    shapes and values for the same segment, read by h5py and by the
    port's own reader."""
    seg = _segment(12, 3, 5, 2, 2, 0)
    tb = TrajectoryBuffer(max_trajectory=100)
    jb = JTrajectoryBuffer(max_trajectory=100)
    assert tb.store_segment(seg) == jb.store_segment(seg) > 0
    ours = tb.save(str(tmp_path / "port"))
    theirs = jb.save(str(tmp_path / "jax"))
    with h5py.File(theirs, "r") as f:
        want = {k: f[k][()] for k in f}
    with h5py.File(ours, "r") as f:
        got_h5py = {k: f[k][()] for k in f}
    got = TrajectoryBuffer.load(ours)
    assert set(want) == set(got_h5py) == set(got) == {
        "observations", "next_observations", "actions", "rewards", "costs",
        "terminals", "timeouts"}
    for k, v in want.items():
        for other in (got_h5py[k], got[k]):
            assert other.dtype == v.dtype and other.ndim == v.ndim, k
            np.testing.assert_array_equal(other, v)


def test_collect_dataset_sweeps_the_limits(tmp_path):
    argv = ["--device", "cpu", "--epochs", "3", "--iters_per_epoch", "1",
            "--n_envs", "2", "--steps_per_collect", "500", "--cost_start",
            "5", "--cost_end", "45", "--logdir", str(tmp_path)]
    path, limits = collect_dataset.main(argv)
    # JAX's formula (examples/customized/collect_dataset.py)
    epochs, start, end = 3, 5.0, 45.0
    assert limits == [start + e / max(epochs - 1, 1) * (end - start)
                      for e in range(epochs)] == [5.0, 25.0, 45.0]
    one = collect_dataset.CollectCfg(epochs=1, cost_start=5.0)
    assert collect_dataset.cost_limit_at(one, 0) == 5.0
    with h5py.File(path, "r") as f:
        data = {k: f[k][()] for k in f}
    n = 2 * 3 * 500      # every env finishes one 500-step episode a collect
    assert {k: (v.dtype, v.shape) for k, v in data.items()} == {
        "observations": (np.float32, (n, 8)),
        "next_observations": (np.float32, (n, 8)),
        "actions": (np.float32, (n, 2)), "rewards": (np.float32, (n,)),
        "costs": (np.float32, (n,)), "terminals": (np.bool_, (n,)),
        "timeouts": (np.bool_, (n,))}
    assert data["timeouts"].sum() == 6


MODULES = ["train_ppol", "train_ppol_lr_decay", "train_trpol",
           "train_ddpgl", "train_sac_custom", "train_cvpo",
           "collect_dataset"]


@pytest.mark.parametrize("name", MODULES)
def test_scripts_need_cuda_unless_cpu_is_asked(tmp_path, name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    mod = importlib.import_module(f"{PKG}.{name}")
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(["--logdir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        eval_main(importlib.import_module(f"{PKG}.eval_ppol").build,
                  ["--path", str(tmp_path)])
