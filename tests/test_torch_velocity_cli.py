"""The port's host velocity command line
(``fsrl_torch/examples/mlp/train_velocity_host.py``) against the JAX
package's example, and the functional trainer wrappers."""

import dataclasses
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from fsrl_torch.algos.ppo_lag import PPOLag
from fsrl_torch.algos.sac_lag import SACLag
from fsrl_torch.envs import make
from fsrl_torch.examples.mlp.train_velocity_host import VelCfg, run
from fsrl_torch.trainer import (OffpolicyTrainer, OnpolicyTrainer,
                                offpolicy_trainer, onpolicy_trainer)
from fsrl_torch.utils.logger import DummyLogger

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _jax_example():
    """``examples/mlp/train_velocity_host.py`` (not a package) as a
    module."""
    path = ROOT / "examples" / "mlp" / "train_velocity_host.py"
    spec = importlib.util.spec_from_file_location("jax_velocity_cli", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_config_matches_the_jax_example():
    """The same fields, in the same order, with the same defaults; the
    port adds ``device``."""
    jfields = [(f.name, f.default)
               for f in dataclasses.fields(_jax_example().VelCfg)]
    fields = [(f.name, f.default) for f in dataclasses.fields(VelCfg)]
    assert fields == jfields + [("device", "cuda")]


def test_unknown_task_is_refused():
    with pytest.raises(ValueError, match="SafetyHumanoidVelocity-v1"):
        run(VelCfg(task="SafetyNoSuchVelocity-v1", device="cpu"),
            logger=DummyLogger())


def test_one_epoch_on_humanoid():
    """One tiny epoch of the command line's ``run`` on the real
    SafetyHumanoidVelocity-v1 (Humanoid-v5: observation 348, 17 actions),
    whose update takes the fused gradient's path (its plain version on the
    CPU)."""
    pytest.importorskip("gymnasium")
    pytest.importorskip("mujoco")
    assert PPOLag(348, 17, device="cpu").use_grad_kernel
    cfg = VelCfg(task="SafetyHumanoidVelocity-v1", epochs=1,
                 step_per_epoch=64, n_envs=2, steps_per_collect=32,
                 episode_per_test=1, device="cpu")
    info = run(cfg, logger=DummyLogger())
    assert (info["epoch"], info["env_step"]) == (1, 64)
    assert math.isfinite(info["test_reward"])
    assert math.isfinite(info["test_cost"])


def _onpolicy_kw():
    env = make("SafetyBallRun-v0")
    algo = PPOLag(env.observation_size, env.action_size, device="cpu",
                  repeat=1, n_minibatches=1, hidden_sizes=(16, 16))
    return (algo, env), dict(epochs=1, step_per_epoch=64, n_envs=4,
                             steps_per_collect=16, episode_per_test=1,
                             verbose=False, seed=3)


def _offpolicy_kw():
    env = make("SafetyBallRun-v0")
    algo = SACLag(env.observation_size, env.action_size, device="cpu",
                  hidden_sizes=(16, 16), batch_size=16)
    return (algo, env), dict(epochs=1, step_per_epoch=64, n_envs=4,
                             steps_per_collect=16, episode_per_test=1,
                             buffer_size=256, update_per_step=0.125,
                             verbose=False, seed=3)


# a trainer's info holds its wall-clock speed, which two runs do not share
_TIMED = {"speed"}


@pytest.mark.parametrize("wrapper,cls,kw", [
    (onpolicy_trainer, OnpolicyTrainer, _onpolicy_kw),
    (offpolicy_trainer, OffpolicyTrainer, _offpolicy_kw)],
    ids=["onpolicy", "offpolicy"])
def test_functional_wrappers_return_the_run_result(wrapper, cls, kw):
    args, kwargs = kw()
    got = wrapper(*args, **kwargs)
    args, kwargs = kw()
    want = cls(*args, **kwargs).run()
    assert set(got) == set(want)
    assert got["epoch"] == 1 and got["env_step"] == 64
    for k in set(want) - _TIMED:
        np.testing.assert_equal(got[k], want[k], err_msg=k)
