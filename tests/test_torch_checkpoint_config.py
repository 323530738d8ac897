"""The port's checkpoints, config command line, run names, task presets,
resume and runtime cost limit: torch twins of
``tests/test_checkpoint_config.py``."""

import dataclasses
import os

import pytest
import torch

from fsrl_torch.agent import PPOLagAgent
from fsrl_torch.algos.cpo import CPO
from fsrl_torch.algos.focops import FOCOPS
from fsrl_torch.algos.ppo_lag import PPOLag
from fsrl_torch.algos.trpo_lag import TRPOLag
from fsrl_torch.config.cli import asdict, cli, parse_config
from fsrl_torch.config.configs import (TASK_TO_PRESET, CPOCfg, FOCOPSCfg,
                                       PPOLagCfg, TRPOLagCfg,
                                       apply_task_preset)
from fsrl_torch.data.collector import make_rollout_fn
from fsrl_torch.envs import make, registered_tasks
from fsrl_torch.trainer.trainer import OnpolicyTrainer
from fsrl_torch.types import EpisodeStats
from fsrl_torch.utils.checkpoint import (load_checkpoint, save_checkpoint,
                                         to_state_dict)
from fsrl_torch.utils.exp_util import (auto_name, load_config_and_model,
                                       seed_all)
from fsrl_torch.utils.logger import BaseLogger, TensorboardLogger

torch.set_num_threads(1)

ALGOS = [PPOLag, TRPOLag, CPO, FOCOPS]


def _leaves(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    else:
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}")


def _trained_state(cls, seed=0):
    """A state one update away from init, so no field holds its default."""
    env = make("SafetyBallRun-v0")
    algo = cls(env.observation_size, env.action_size, cost_limit=2.0,
               hidden_sizes=(16, 16), device="cpu")
    g = torch.Generator().manual_seed(seed)
    state = algo.init(seed=seed)
    res = make_rollout_fn(env, algo.act_fn, 16, device="cpu")(
        state.params, env.reset_vec(4, g), EpisodeStats.init(4, 1), g)
    state, _ = algo.update(state, res.transitions, torch.tensor([5.0]),
                           torch.tensor(2, dtype=torch.int32), g)
    return algo, state


@pytest.mark.parametrize("cls", ALGOS, ids=[c.name for c in ALGOS])
def test_checkpoint_roundtrip_exact(cls, tmp_path):
    algo, state = _trained_state(cls)
    if hasattr(state, "lag"):
        state.lag.multiplier = torch.tensor([3.5])
        state.lag.error_integral = torch.tensor([7.0])
    path = os.path.join(tmp_path, "ck", "model.pt")
    save_checkpoint(path, state)
    fresh = algo.init(seed=1)
    assert not torch.equal(fresh.flat, state.flat)
    restored = load_checkpoint(path, fresh)
    assert restored is fresh
    saved, got = dict(_leaves(to_state_dict(state))), dict(
        _leaves(to_state_dict(restored)))
    assert set(saved) == set(got) and len(saved) > 15
    for name in saved:
        assert torch.equal(saved[name], got[name]), name
        assert saved[name].dtype == got[name].dtype, name
    # the parameters are still views of the flat vector, which holds them
    assert torch.equal(restored.flat, state.flat)
    restored.flat.add_(1.0)
    p = next(restored.params.parameters())
    assert torch.equal(p, next(state.params.parameters()) + 1.0)
    if hasattr(state, "lag"):
        assert float(restored.lag.multiplier[0]) == 3.5
    assert int(restored.update_count) == 1
    # the file itself holds plain tensors addressed by field name
    raw = load_checkpoint(path)
    assert "flat" not in raw and "actor.mu.weight" in raw["params"]


def test_checkpoint_structure_mismatch_raises(tmp_path):
    state = PPOLag(5, 2, device="cpu").init()
    path = os.path.join(tmp_path, "ck.pt")
    save_checkpoint(path, state)
    # other shapes
    with pytest.raises(ValueError, match="mismatch"):
        load_checkpoint(path, PPOLag(7, 3, device="cpu").init())
    # another algorithm's state: fields the target does not have
    with pytest.raises(ValueError, match="no \\["):
        load_checkpoint(path, CPO(5, 2, device="cpu").init())
    # another constraint count
    with pytest.raises(ValueError, match="mismatch"):
        load_checkpoint(path, PPOLag(5, 2, num_costs=2, device="cpu").init())


def test_checkpoint_migration_fills_missing_fields(tmp_path):
    """A file written before a state grew fields restores, and the new
    fields keep the target's values."""
    algo = PPOLag(5, 2, cost_limit=10.0, device="cpu")
    state = algo.init(seed=0)
    state.lag.multiplier = torch.tensor([3.5])
    sd = to_state_dict(state)
    del sd["lag"]["cost_ema"], sd["lag"]["ema_n"]
    path = os.path.join(tmp_path, "old_ck.pt")
    torch.save(sd, path)
    target = algo.init(seed=1)
    target.lag.ema_n = torch.tensor(4.0)
    restored = load_checkpoint(path, target)
    assert float(restored.lag.multiplier[0]) == 3.5
    assert torch.equal(restored.lag.cost_ema, torch.zeros(1))
    assert float(restored.lag.ema_n) == 4.0
    assert torch.equal(restored.flat, state.flat)


def test_cli_flag_parsing():
    cfg = parse_config(PPOLagCfg, [
        "--task", "SafetyBallRun-v0", "--cost_limit", "25",
        "--lagrangian_pid", "0.1,0.001,0.2", "--use_lagrangian", "false",
        "--epochs", "7", "--hidden_sizes", "64,64", "--max_grad_norm", "1.5"])
    assert cfg.task == "SafetyBallRun-v0"
    assert cfg.cost_limit == 25.0
    assert cfg.lagrangian_pid == (0.1, 0.001, 0.2)
    assert cfg.use_lagrangian is False
    assert cfg.epochs == 7
    assert cfg.hidden_sizes == (64, 64)
    assert cfg.max_grad_norm == 1.5
    with pytest.raises(SystemExit):
        parse_config(PPOLagCfg, ["--no_such_field", "1"])


def test_cli_yaml_with_flag_override(tmp_path):
    import yaml
    p = os.path.join(tmp_path, "cfg.yaml")
    with open(p, "w") as f:
        yaml.safe_dump({"cost_limit": 50.0, "epochs": 11,
                        "lagrangian_pid": [1.0, 2.0, 3.0],
                        "use_mesh": True}, f)   # unknown keys are ignored
    cfg = parse_config(PPOLagCfg, ["--config", p, "--epochs", "3"])
    assert cfg.cost_limit == 50.0   # from yaml
    assert cfg.epochs == 3          # the flag wins
    assert cfg.lagrangian_pid == (1.0, 2.0, 3.0)

    @cli(FOCOPSCfg)
    def main(c):
        return c

    got = main(["--nu_max", "3.5"])
    assert isinstance(got, FOCOPSCfg) and got.nu_max == 3.5
    assert asdict(got)["nu_max"] == 3.5


@pytest.mark.parametrize("cfg_cls,algo_cls", [
    (PPOLagCfg, PPOLag), (TRPOLagCfg, TRPOLag), (CPOCfg, CPO),
    (FOCOPSCfg, FOCOPS)], ids=["ppol", "trpol", "cpo", "focops"])
def test_config_builds_its_algorithm(cfg_cls, algo_cls):
    """``algo_kwargs`` names only constructor arguments, and the config's
    defaults are the algorithm's."""
    cfg = cfg_cls()
    algo = algo_cls(5, 2, cost_limit=cfg.cost_limit, device="cpu",
                    **cfg.algo_kwargs())
    default = algo_cls(5, 2, cost_limit=cfg.cost_limit, device="cpu")
    assert algo.hp == default.hp
    assert algo.hidden_sizes == default.hidden_sizes == (128, 128)


def test_auto_name_diffs_only():
    d, c = PPOLagCfg(), PPOLagCfg(cost_limit=25.0, lr=1e-3)
    name = auto_name(d, c, prefix="ppol")
    assert name.startswith("ppol-")
    assert "cost_limi25" in name.replace(".0", "")
    assert "lr0.001" in name
    assert "task" not in name  # skip-listed
    assert auto_name(d, d, suffix="x").endswith("-x")
    seed_all(3)
    a = torch.rand(2)
    seed_all(3)
    assert torch.equal(a, torch.rand(2))


def test_task_presets():
    cfg = apply_task_preset(PPOLagCfg(task="SafetyBallRun-v0"))
    assert cfg.epochs * cfg.step_per_epoch == 1_000_000
    cfg2 = apply_task_preset(PPOLagCfg(task="SafetyCarCircle-v0"))
    assert cfg2.epochs == 200  # the default 2M budget, untouched
    cfg3 = apply_task_preset(CPOCfg(task="SafetyAntCircle-v0",
                                    cost_limit=3.0))
    assert cfg3.epochs * cfg3.step_per_epoch == 10_000_000
    assert cfg3.cost_limit == 10.0
    assert apply_task_preset(TRPOLagCfg(task="SafetyDroneCircle-v0")
                             ).epochs == 500
    # every task the port has gets a preset row, and no other: the 9 Run /
    # Circle / Drone / Ant tasks and the 16 navigation tasks (batched), and
    # the 6 velocity tasks (host envs)
    from fsrl_torch.envs.velocity import velocity_tasks
    assert set(TASK_TO_PRESET) == set(registered_tasks()) | set(
        velocity_tasks())
    assert len(registered_tasks()) == 25 and len(velocity_tasks()) == 6
    # the velocity rows, and a reference velocity id resolved first
    cfg6 = apply_task_preset(PPOLagCfg(
        task="SafetyWalker2dVelocityGymnasium-v1"))
    assert cfg6.task == "SafetyWalker2dVelocity-v1"
    assert (cfg6.epochs * cfg6.step_per_epoch, cfg6.cost_limit) == \
        (10_000_000, 25.0)
    # the navigation rows, and a reference task id resolved first
    cfg4 = apply_task_preset(PPOLagCfg(task="SafetyPointGoal1Gymnasium-v0"))
    assert cfg4.task == "SafetyPointGoal1-v0"
    assert (cfg4.epochs * cfg4.step_per_epoch, cfg4.cost_limit) == \
        (5_000_000, 25.0)
    cfg5 = apply_task_preset(PPOLagCfg(task="SafetyCarCircle2-v0"))
    assert cfg5.epochs * cfg5.step_per_epoch == 2_000_000


def test_trainer_checkpoints_and_resume(tmp_path):
    """The trainer writes ``model.pt`` every ``save_model_interval`` epochs
    and ``model_best.pt``; ``resume_from`` restores the whole state and,
    from the Tensorboard events, the epoch and env-step counts."""
    pytest.importorskip("tensorboard")
    logger = TensorboardLogger(str(tmp_path), name="run")
    agent = PPOLagAgent("SafetyBallRun-v0", cost_limit=25.0, seed=0,
                        logger=logger, device="cpu", hidden_sizes=(32, 32))
    logger.save_config(PPOLagCfg(task="SafetyBallRun-v0", cost_limit=25.0,
                                 hidden_sizes=(32, 32)))
    agent.learn(epochs=2, step_per_epoch=2000, n_envs=4,
                steps_per_collect=250, episode_per_test=2,
                save_model_interval=2)
    run = os.path.join(tmp_path, "run")
    ck = os.path.join(run, "checkpoint", "model.pt")
    assert os.path.isfile(ck)
    assert os.path.isfile(os.path.join(run, "checkpoint", "model_best.pt"))
    assert os.path.isfile(os.path.join(run, "progress.txt"))
    trained = int(agent.state.update_count)
    assert trained == 4
    assert logger.restore_data() == (2, 4000, int(agent.state.gradient_steps))

    t2 = OnpolicyTrainer(agent.algo, agent.env, logger, cost_limit=25.0,
                         epochs=3, step_per_epoch=1000, n_envs=4,
                         steps_per_collect=250, episode_per_test=2,
                         verbose=False, resume_from=ck)
    assert int(t2.state.update_count) == trained
    assert torch.equal(t2.state.flat, agent.state.flat)
    assert (t2.epoch, t2.env_step) == (2, 4000)
    info = t2.run()        # one more epoch: the third
    assert info["epoch"] == 3 and info["env_step"] == 5000
    assert int(t2.state.update_count) == trained + 1

    # a plain logger keeps no counters; a run directory reloads
    assert BaseLogger().restore_data() == (0, 0, 0)
    config, state = load_config_and_model(run, best=True,
                                          target=agent.algo.init(seed=5))
    assert config["task"] == "SafetyBallRun-v0"
    assert config["hidden_sizes"] == [32, 32]
    assert int(state.update_count) > 0
    raw_cfg, raw = load_config_and_model(run)
    assert "params" in raw and raw_cfg == config


def test_save_model_interval_without_log_dir_writes_nothing(tmp_path,
                                                            monkeypatch):
    agent = PPOLagAgent("SafetyBallRun-v0", seed=0, device="cpu",
                        hidden_sizes=(16, 16))
    monkeypatch.chdir(tmp_path)
    agent.learn(epochs=1, step_per_epoch=500, n_envs=2,
                steps_per_collect=250, episode_per_test=1)
    assert os.listdir(tmp_path) == []


def test_runtime_cost_limit_override():
    """Every algorithm takes a runtime cost limit in ``update``."""
    env = make("SafetyBallRun-v0")
    g = torch.Generator().manual_seed(0)
    act = lambda p, o, gen: (
        torch.rand(o.shape[:-1] + (2,), generator=gen) * 2 - 1,
        torch.zeros(o.shape[:-1]))
    res = make_rollout_fn(env, act, 32, device="cpu")(
        None, env.reset_vec(4, g), EpisodeStats.init(4, 1), g)
    for cls in ALGOS:
        algo = cls(env.observation_size, env.action_size, cost_limit=10.0,
                   hidden_sizes=(32, 32), device="cpu")
        outs = {}
        for lim in (0.001, 10000.0):
            arr = torch.tensor([lim]) if cls is not CPO else torch.tensor(lim)
            outs[lim] = algo.update(
                algo.init(seed=0), res.transitions, torch.tensor([5.0]),
                torch.tensor(1, dtype=torch.int32),
                torch.Generator().manual_seed(2), cost_limit=arr)
        if cls in (PPOLag, TRPOLag):
            # the tight limit engages the multiplier, the loose one not
            assert float(outs[0.001][0].lag.multiplier[0]) > 0.0
            assert float(outs[10000.0][0].lag.multiplier[0]) == 0.0
        if cls is FOCOPS:
            assert float(outs[0.001][0].nu) > float(outs[10000.0][0].nu)
        if cls is CPO:
            assert float(outs[0.001][1]["loss/optim_C"]) > 0
            assert float(outs[10000.0][1]["loss/optim_C"]) < 0


def test_config_dataclasses_have_no_unused_device_fields():
    names = {f.name for f in dataclasses.fields(PPOLagCfg)}
    assert {"task", "cost_limit", "lr", "repeat"} <= names
    assert not {"use_mesh", "buffer_size", "update_per_step"} & names
