"""The port's learning-curve runner and summary tables
(``fsrl_torch.examples.run_curves``, ``make_summaries``) against the JAX
package's ``benchmarks/run_curves.py`` and ``make_summaries.py`` on the
CPU: the result JSON's keys, the summary text, and the rules the new
entry points keep (no JAX, nothing written into ``benchmarks/``)."""

import ast
import importlib.util
import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

from fsrl_torch.examples import make_summaries, run_curves

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
RESULTS = ROOT / "benchmarks" / "results_1m"
REF = RESULTS / "SafetyBallCircle-v0-sacl-s0.json"
TINY = ["--device", "cpu", "--task", "SafetyBallCircle-v0", "--seeds", "0",
        "--step_per_epoch", "100", "--budget", "100", "--off_budget", "100",
        "--n_envs", "2", "--steps_per_collect", "50", "--off_n_envs", "2",
        "--off_steps_per_collect", "50", "--episode_per_test", "1"]


def _jax_module(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod      # its dataclass looks itself up there
    spec.loader.exec_module(mod)
    return mod


def _jax_summaries():
    return _jax_module("make_summaries")


@pytest.mark.parametrize("algo,extra,more", [
    ("sacl", [], set()),
    ("ppol", ["--pid_onpolicy", "0.1,0.001,0.1"], {"pid"})])
def test_runner_writes_the_jax_runner_keys(tmp_path, algo, extra, more):
    rows = run_curves.main(TINY + extra + ["--algos", algo, "--outdir",
                                           str(tmp_path)])
    with open(tmp_path / f"SafetyBallCircle-v0-{algo}-s0.json") as f:
        row = json.load(f)
    with open(REF) as f:
        want = set(json.load(f)) | more
    assert set(row) == want and rows == [row]
    assert len(row["curve"]["reward"]) == 1 and row["budget"] == 100
    assert row["n_envs"] == 2 and row["steps_per_collect"] == 50
    if more:
        assert row["pid"] == "0.1,0.001,0.1"
    summary = (tmp_path / "summary-SafetyBallCircle-v0.md").read_text()
    assert f"| {algo} | 0 | 100 |" in summary


def test_runner_overrides_match_jax():
    """The algorithms' overrides are the JAX runner's (its ``AGENTS`` and
    the optional ones of ``CurveCfg``)."""
    src = (ROOT / "benchmarks" / "run_curves.py").read_text()
    assert '"ddpgl": (DDPGLagAgent, False, {"lagrangian_pid": ' \
           '(0.05, 0.0005, 0.1)})' in src
    assert '"trpol": (TRPOLagAgent, True, {"target_kl": 0.005})' in src
    assert {k: (c.__name__, on, kw)
            for k, (c, on, kw) in run_curves.AGENTS.items()} == {
        "ppol": ("PPOLagAgent", True, {}),
        "trpol": ("TRPOLagAgent", True, {"target_kl": 0.005}),
        "cpo": ("CPOAgent", True, {}), "focops": ("FOCOPSAgent", True, {}),
        "ddpgl": ("DDPGLagAgent", False,
                  {"lagrangian_pid": (0.05, 0.0005, 0.1)}),
        "sacl": ("SACLagAgent", False, {}),
        "cvpo": ("CVPOAgent", False, {})}
    cfg = run_curves.CurveCfg(pid_onpolicy="1,2,3", nu_max=3.0, qc_ucb=0.5,
                              sigma_floor=-2.0)
    assert run_curves.agent_kwargs(cfg, "trpol") == {
        "target_kl": 0.005, "lagrangian_pid": (1.0, 2.0, 3.0),
        "sigma_floor": -2.0}
    assert run_curves.agent_kwargs(cfg, "focops") == {"nu_max": 3.0}
    assert run_curves.agent_kwargs(cfg, "sacl") == {"qc_ucb": 0.5}
    assert run_curves.agent_kwargs(cfg, "cpo") == {"sigma_floor": -2.0}
    assert run_curves.agent_kwargs(run_curves.CurveCfg(), "ddpgl") == {
        "lagrangian_pid": (0.05, 0.0005, 0.1)}


def test_runner_passes_jax_off_policy_dispatch_settings(monkeypatch,
                                                       tmp_path):
    """The runner's off-policy trainer gets JAX's ``fuse_iters``
    (``off_fuse_iters``, ``benchmarks/run_curves.py:103-104``) and
    ``update_chunk``; the on-policy one neither."""
    jax_cfg = _jax_module("run_curves").CurveCfg()
    assert run_curves.CurveCfg().off_fuse_iters == jax_cfg.off_fuse_iters
    built = []

    class Recorded(run_curves.OffpolicyTrainer):
        def __init__(self, *args, **kwargs):
            built.append(kwargs)
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(run_curves, "OffpolicyTrainer", Recorded)
    run_curves.main(TINY + ["--algos", "sacl", "--off_fuse_iters", "2",
                            "--outdir", str(tmp_path)])
    (kw,) = built
    assert (kw["fuse_iters"], kw["update_chunk"]) == (2, 256)


def test_runner_refuses_benchmarks_and_unknown_algos(tmp_path):
    with pytest.raises(ValueError, match="benchmarks"):
        run_curves.main(TINY + ["--algos", "sacl", "--outdir",
                                str(ROOT / "benchmarks" / "x")])
    assert not (ROOT / "benchmarks" / "x").exists()
    with pytest.raises(KeyError, match="unknown algos"):
        run_curves.main(TINY + ["--algos", "sacl,bogus", "--outdir",
                                str(tmp_path)])
    assert not list(tmp_path.iterdir())


def test_runner_needs_cuda_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_curves.main(["--algos", "sacl", "--outdir", str(tmp_path)])


def test_summary_text_equals_jax(tmp_path):
    """One task's committed JSONs, one of them without its ``best_*``
    fields (rebuilt from the curve) and one under a ``-pid`` name: the
    port's table is JAX's, character for character."""
    jax_ms = _jax_summaries()
    for side in ("jax", "port"):
        d = tmp_path / side
        d.mkdir()
        for f in sorted(RESULTS.glob("SafetyBallCircle-v0-*.json")):
            shutil.copy(f, d / f.name)
        row = json.loads((d / "SafetyBallCircle-v0-ppol-s1.json").read_text())
        del row["best_reward"], row["best_cost"]
        (d / "SafetyBallCircle-v0-ppol-s1.json").write_text(json.dumps(row))
        shutil.copy(d / "SafetyBallCircle-v0-cpo-s0.json",
                    d / "SafetyBallCircle-v0-ppol-s0-pid.json")
    jax_ms.summarize_dir(str(tmp_path / "jax"), plot_curves=False)
    make_summaries.summarize_dir(str(tmp_path / "port"))
    name = "summary-SafetyBallCircle-v0.md"
    want = (tmp_path / "jax" / name).read_text()
    assert (tmp_path / "port" / name).read_text() == want
    assert "(pid-retune)" in want and want.count("\n| ") == 23
    assert not list((tmp_path / "port").glob("*.png"))


NEW = ["examples/run_curves.py", "examples/make_summaries.py",
       "data/hdf5.py"] + [
    f"examples/customized/{n}.py" for n in (
        "__init__", "custom_common", "train_ppol", "eval_ppol",
        "train_ppol_lr_decay", "train_trpol", "eval_trpol",
        "collect_dataset", "train_ddpgl", "eval_ddpgl", "train_sac_custom",
        "eval_sacl", "train_cvpo", "eval_cvpo")]


def test_new_modules_import_no_jax_benchmarks_or_examples():
    """The modules of the training-quality entry points import the port
    and torch: not JAX, optax or the JAX package, and nothing of the
    repository's ``benchmarks/`` or ``examples/``."""
    for rel in NEW:
        path = ROOT / "fsrl_torch" / rel
        names = set()
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                names.add(node.module.split(".")[0])
        bad = names & {"jax", "jaxlib", "flax", "optax", "orbax",
                       "fsrl_tpu", "benchmarks", "examples",
                       "custom_common", "make_summaries"}
        assert not bad, f"{rel} imports {bad}"
