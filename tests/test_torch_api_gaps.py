"""Parts of modules ported earlier that the port lacked, against the JAX
package: the logger's running statistics, colour, streaming write,
``print`` and checkpoint hooks; ``RunningMeanStd.normalize`` / ``scale`` /
``unscale``; ``discounted_returns``; the trainer's ``collect_time``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import n

from fsrl_tpu.ops.gae import discounted_returns as j_discounted_returns
from fsrl_tpu.ops.running_stats import RunningMeanStd as JRunningMeanStd
from fsrl_tpu.utils import logger as jlog
from fsrl_torch.algos.ppo_lag import PPOLag
from fsrl_torch.envs import make
from fsrl_torch.ops.gae import discounted_returns
from fsrl_torch.ops.running_stats import RunningMeanStd
from fsrl_torch.trainer.trainer import OnpolicyTrainer
from fsrl_torch.utils import logger as tlog

torch.set_num_threads(1)


def _filled(cls, xs):
    ra = cls()
    for x in xs:
        ra.add(float(x))
    return ra


def test_running_average_std_and_merge_match_jax():
    xs = np.random.default_rng(0).normal(3.0, 2.0, size=37)
    for part in (xs, xs[:1], xs[:0]):
        t_ra, j_ra = _filled(tlog.RunningAverage, part), _filled(
            jlog.RunningAverage, part)
        assert (t_ra.n, t_ra.mean, t_ra.std) == pytest.approx(
            (j_ra.n, j_ra.mean, j_ra.std), rel=1e-12)
    t_sum = _filled(tlog.RunningAverage, xs[:20]) + _filled(
        tlog.RunningAverage, xs[20:])
    j_sum = _filled(jlog.RunningAverage, xs[:20]) + _filled(
        jlog.RunningAverage, xs[20:])
    assert (t_sum.n, t_sum.mean, t_sum.std) == pytest.approx(
        (j_sum.n, j_sum.mean, j_sum.std), rel=1e-12)
    # the merge is the average of the concatenation
    assert t_sum.std == pytest.approx(float(np.std(xs)), rel=1e-12)
    empty = tlog.RunningAverage() + tlog.RunningAverage()
    assert (empty.n, empty.mean, empty.std) == (0, 0.0, 0.0)


@pytest.mark.parametrize("color,bold", [("green", False), ("red", True),
                                        ("nonsense", True)])
def test_colorize_matches_jax(color, bold):
    assert tlog.colorize("msg", color, bold) == jlog.colorize("msg", color,
                                                              bold)


class _Rows:
    """A logger mixin that records what reaches the stream hook."""

    def _stream(self, row, step):
        self.rows = getattr(self, "rows", []) + [(step, dict(row))]


@pytest.mark.parametrize("mod", [tlog, jlog], ids=["port", "jax"])
def test_logger_hooks(mod, tmp_path, capsys):
    """``get_mean``, ``write_without_reset``, ``print`` and the checkpoint
    hooks behave alike in the port and the JAX package."""
    logger = type("L", (_Rows, mod.BaseLogger), {})(str(tmp_path), False)
    logger.store(tab="train", reward=1.0)
    logger.store(tab="train", reward=3.0)
    assert logger.get_mean("train/reward") == 2.0
    assert logger.get_mean("train/cost") == 0.0
    logger.write_without_reset(7)
    assert logger.rows == [(7, {"train/reward": 2.0})]
    assert logger.get_mean("train/reward") == 2.0      # kept
    logger.print("hello", "cyan")
    assert capsys.readouterr().out == mod.colorize("hello", "cyan",
                                                   bold=True) + "\n"
    saved = []
    logger.save_checkpoint("x")                        # no hook: nothing
    logger.setup_checkpoint_fn(saved.append)
    logger.save_checkpoint()
    logger.save_checkpoint("best")
    assert saved == [None, "best"]
    dummy = mod.DummyLogger()
    dummy.write_without_reset(1)
    dummy.print("quiet")
    assert capsys.readouterr().out == ""


def test_running_mean_std_normalize_scale_unscale_match_jax():
    rng = np.random.default_rng(1)
    batch = rng.normal(2.0, 3.0, size=(64, 3)).astype(np.float32)
    x = rng.normal(size=(5, 3)).astype(np.float32)
    jr = JRunningMeanStd.init((3,)).update(jnp.asarray(batch))
    tr = RunningMeanStd.init((3,)).update(torch.from_numpy(batch))
    for name in ("normalize", "scale", "unscale"):
        want = np.asarray(getattr(jr, name)(jnp.asarray(x)))
        got = n(getattr(tr, name)(torch.from_numpy(x)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                   err_msg=name)
    np.testing.assert_allclose(n(tr.unscale(tr.scale(torch.from_numpy(x)))),
                               x, rtol=1e-6)


def test_discounted_returns_matches_jax():
    """XLA may fuse the multiply-add of the recursion; the port rounds
    twice, as in test_torch_gae.py: rtol 1e-6 and 1e-6 of the largest
    return."""
    rng = np.random.default_rng(2)
    T, N, K = 40, 6, 2
    m = rng.normal(size=(T, N, K)).astype(np.float32)
    end = rng.random((T, N)) < 0.1
    boot = rng.normal(size=(N, K)).astype(np.float32)
    want = np.asarray(j_discounted_returns(jnp.asarray(m), jnp.asarray(end),
                                           jnp.asarray(boot), 0.97))
    got = n(discounted_returns(torch.from_numpy(m), torch.from_numpy(end),
                               torch.from_numpy(boot), 0.97))
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def test_trainer_collect_time():
    """The host seconds of the epochs' train iterations, summed over the
    epochs (as the JAX trainer keeps them)."""
    env = make("SafetyBallRun-v0")
    algo = PPOLag(env.observation_size, env.action_size, device="cpu",
                  repeat=1, n_minibatches=1, hidden_sizes=(16, 16))
    tr = OnpolicyTrainer(algo, env, epochs=2, step_per_epoch=64, n_envs=4,
                         steps_per_collect=16, episode_per_test=1,
                         verbose=False)
    assert tr.collect_time == 0.0
    next(tr)
    first = tr.collect_time
    assert first > 0.0
    next(tr)
    assert tr.collect_time > first
