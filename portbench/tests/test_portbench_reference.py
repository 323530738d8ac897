"""The plain references against second computations at tiny sizes on
the CPU."""

import math

import pytest
import torch

from portbench import compare, harness
from portbench.reference import common, envs, ppo_lag, sac_lag
from portbench.tests.conftest import TINY

BENCH = harness.load_json(harness.REPO / "BENCHMARK.json")


def config(name):
    (c,) = [c for c in BENCH["configs"] if c["name"] == name]
    return harness.load_json(harness.REPO / c["file"])


def test_adam_is_torchs_adam():
    g = torch.Generator().manual_seed(0)
    w = torch.randn(5, 3, generator=g)
    ref = torch.nn.Parameter(w.clone())
    opt = torch.optim.Adam([ref], lr=1e-2, eps=1e-8)
    adam = common.Adam(1e-2)
    params, state = {"w": w.clone()}, adam.init({"w": w})
    for _ in range(4):
        grad = torch.randn(5, 3, generator=g)
        ref.grad = grad.clone()
        opt.step()
        params, state = adam.step(params, {"w": grad}, state)
    torch.testing.assert_close(params["w"], ref.detach(), rtol=1e-5,
                               atol=1e-6)


def test_global_norm_clip():
    adam = common.Adam(1.0, max_grad_norm=0.5)
    params = {"a": torch.zeros(2), "b": torch.zeros(1)}
    grads = {"a": torch.tensor([3.0, 0.0]), "b": torch.tensor([4.0])}
    _, state = adam.step(params, grads, adam.init(params))
    # mu = 0.1 x the clipped gradient, norm 5 cut to 0.5
    torch.testing.assert_close(state["mu"]["a"], torch.tensor([0.03, 0.0]))
    torch.testing.assert_close(state["mu"]["b"], torch.tensor([0.04]))


def test_gae_is_the_closed_form():
    """The advantage is the discounted sum of the TD errors up to the
    step where the episode ended."""
    hp = config("ppol-carcircle-f32")["algorithm_kwargs"]
    gl = hp["gamma"] * hp["gae_lambda"]
    g = torch.Generator().manual_seed(1)
    delta = torch.randn(6, 1, 2, generator=g, dtype=torch.float64)
    done = torch.tensor([[False], [False], [True], [False], [False],
                         [False]])
    got = ppo_lag.gae(delta, done, gl)
    for t in range(6):
        end = 3 if t < 3 else 6
        want = sum(gl ** (k - t) * delta[k, 0] for k in range(t, end))
        torch.testing.assert_close(got[t, 0], want)


def test_car_circle_step_by_hand():
    task = config("ppol-carcircle-f32")["task"]
    car = envs.CarCircle(task)
    s = dict(pos=torch.tensor([[7.0, 0.0]]),
             heading=torch.tensor([math.pi / 2]), speed=torch.tensor([1.0]))
    n = car.step(s, torch.tensor([[0.5, 0.0]]))
    speed = 1.0 + 0.1 * (8.0 * 0.5 - 1.0)
    assert float(n["speed"]) == pytest.approx(speed)
    assert n["pos"][0].tolist() == pytest.approx([7.0, 0.1 * speed],
                                                 abs=1e-6)
    reward, cost = car.task.reward_cost(n["pos"], car.vel(n))
    # counter-clockwise on the circle: (x v_y - y v_x) / radius = speed,
    # over 1 + the distance off the circle
    dist = math.hypot(7.0, 0.1 * speed)
    assert float(reward) == pytest.approx(speed / (1 + dist - 7.0),
                                          rel=1e-5)
    assert float(cost) == 1.0                      # |x| = 7 > 4


@pytest.mark.parametrize("config_name", sorted(TINY))
def test_reference_against_the_port_on_the_cpu(config_name):
    """The port's plain CPU path is a second computation of the same
    training: the first steps agree to rounding."""
    import importlib
    cfg = config(config_name)
    traffic = TINY[config_name]
    driver = importlib.import_module(f"portbench.drivers.{cfg['driver']}")
    ref_mod = importlib.import_module(
        f"portbench.reference.{cfg['algorithm']}")
    prog = driver.Program(cfg, traffic, 5, "cpu")
    prog.check_dispatches()
    ref = ref_mod.run(cfg, traffic, prog.weights, 5, "cpu", checked=3)
    gaps = compare.gaps(prog.readings, ref)
    assert gaps["loss_gap"] < 1e-4
    assert gaps["grad_gap"] < 1e-5
    assert gaps["change_gap"] < 1e-4


def test_sac_reference_target_by_hand():
    """Two-step targets at the chain's end: the newest row counts as an
    episode's end."""
    cfg = config("sacl-ballcircle-f32")
    traffic = dict(TINY["sacl-ballcircle-f32"], fill_collects=0)
    ref = sac_lag.SACLagReference(cfg, traffic, sac_weights(cfg), 3, "cpu")
    ref.collect()
    newest = traffic["steps_per_collect"] - 1
    rows = torch.tensor([newest, newest - 1])
    env = torch.tensor([0, 0])
    gen_state = ref.g.get_state()
    _, y = ref.targets(rows, env)
    gam = cfg["algorithm_kwargs"]["gamma"]
    m = ref.buf["m"]
    # the newest row: its own reward, then gamma times the bootstrap
    ref.g.set_state(gen_state)
    a, logp = sac_lag.sample(ref.actor_p, ref.buf["obs_next"][[newest,
                                                               newest], 0],
                             ref.g)
    q = sac_lag.heads(sac_lag.q_values(
        ref.target, ref.buf["obs_next"][[newest, newest], 0], a,
        "critics."))
    boot = q[:, 0] - logp
    assert float(y[0, 0]) == pytest.approx(
        float(m[newest, 0, 0] + gam * boot[0]), rel=1e-5)
    assert float(y[1, 0]) == pytest.approx(
        float(m[newest - 1, 0, 0] + gam * m[newest, 0, 0]
              + gam ** 2 * boot[1]), rel=1e-5)


def sac_weights(cfg):
    from portbench.drivers.offpolicy import make_weights
    return make_weights(cfg, 3, "cpu")
