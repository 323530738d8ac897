"""Which form the collector's rollout takes (``collector.rollout_form``),
and the car and ball resets split into their draws and their arithmetic.

The rollout kernel runs only on the card, so the form is asked of a CUDA
env state's stand-in: ``rollout_form`` reads the state's device and
nothing else of it. The kernel form is the actor that the on-policy
algorithms name (``ActorCriticAlgo.rollout_actor``: a free log-sigma, a
bounded mean, two ReLU layers of 128 or of 256 units, f32) on the car and
ball envs, from a plain generator; everything else, a rollout given no
actor among it, takes the loop.
"""

import math
import types

import pytest
import torch

from fsrl_torch.data import collector
from fsrl_torch.envs import make
from fsrl_torch.envs.base import uniform
from fsrl_torch.envs.tasks import CircleTask
from fsrl_torch.parallel.mesh import EnvRows
from fsrl_torch.types import EpisodeStats

torch.set_num_threads(1)

KERNEL_TASKS = ["SafetyCarCircle-v0", "SafetyCarRun-v0",
                "SafetyBallCircle-v0", "SafetyBallRun-v0",
                "SafetyBallCircle2C-v0"]
ON_CARD = types.SimpleNamespace(
    obs=types.SimpleNamespace(device=torch.device("cuda")))


def _algo(name, env, **kw):
    from fsrl_torch.algos.cpo import CPO
    from fsrl_torch.algos.cvpo import CVPO
    from fsrl_torch.algos.ddpg_lag import DDPGLag
    from fsrl_torch.algos.focops import FOCOPS
    from fsrl_torch.algos.ppo_lag import PPOLag
    from fsrl_torch.algos.ppo_lag_rnn import RecurrentPPOLag
    from fsrl_torch.algos.sac_lag import SACLag
    from fsrl_torch.algos.trpo_lag import TRPOLag
    cls = dict(ppo_lag=PPOLag, focops=FOCOPS, trpo_lag=TRPOLag, cpo=CPO,
               sac_lag=SACLag, cvpo=CVPO, ddpg_lag=DDPGLag,
               ppo_lag_rnn=RecurrentPPOLag)[name]
    if env.num_costs > 1:
        kw["cost_limit"] = [10.0] * env.num_costs
        kw["num_costs"] = env.num_costs
    return cls(env.observation_size, env.action_size, device="cpu", **kw)


def _form(algo, env, generator=None, state=ON_CARD, **kw):
    """The form of the rollout the trainer builds: given the actor that
    the algorithm names, where it names one."""
    g = generator or torch.Generator().manual_seed(0)
    actor = getattr(algo, "rollout_actor", None)
    return collector.rollout_form(
        env, actor and actor(algo.init(0).params), state, g, **kw)


@pytest.mark.parametrize("task", KERNEL_TASKS)
def test_ppo_lag_on_the_car_and_ball_envs_takes_the_kernel(task):
    env = make(task)
    assert _form(_algo("ppo_lag", env), env) == "kernel"


@pytest.mark.parametrize("task", KERNEL_TASKS)
def test_ppo_lag_at_hidden_256_takes_the_kernel(task):
    """The Safety Gym baselines' widths, two layers of 256 units."""
    env = make(task)
    assert _form(_algo("ppo_lag", env, hidden_sizes=(256, 256)),
                 env) == "kernel"


@pytest.mark.parametrize("name,kw", [
    ("focops", {}), ("trpo_lag", {}), ("cpo", {}),
    ("cpo", dict(sigma_floor=0.3))])
def test_the_other_gaussian_on_policy_actors_take_the_kernel(name, kw):
    env = make("SafetyCarCircle-v0")
    assert _form(_algo(name, env, **kw), env) == "kernel"


@pytest.mark.parametrize("name", ["sac_lag", "cvpo", "ddpg_lag"])
def test_off_policy_actors_take_the_loop(name):
    """They name no actor for the kernel, and theirs is outside it."""
    env = make("SafetyBallCircle-v0")
    algo = _algo(name, env)
    assert _form(algo, env) == "loop"
    assert collector.rollout_form(
        env, algo.init(0).params.actor, ON_CARD,
        torch.Generator().manual_seed(0)) == "loop"


@pytest.mark.parametrize("case", [
    "recurrent", "env_rows", "reset_states", "bf16", "hidden_64",
    "hidden_256x128", "hidden_512", "unbounded", "wrapped_act_fn", "cpu"])
def test_outside_the_envelope_takes_the_loop(case):
    env = make("SafetyCarCircle-v0")
    kw = dict(bf16=dict(compute_dtype=torch.bfloat16),
              hidden_64=dict(hidden_sizes=(64, 64)),
              hidden_256x128=dict(hidden_sizes=(256, 128)),
              hidden_512=dict(hidden_sizes=(512, 512)),
              unbounded=dict(unbounded=True)).get(case, {})
    algo = _algo("ppo_lag_rnn" if case == "recurrent" else "ppo_lag", env,
                 **kw)
    params = algo.init(0).params
    g = torch.Generator().manual_seed(0)
    args = dict(env=env, actor=getattr(params, "actor", None),
                env_state=ON_CARD, generator=g)
    if case == "recurrent":
        args["recurrent"] = True
    elif case == "env_rows":
        args["generator"] = EnvRows(g, 8, 0, 4)
    elif case == "reset_states":
        args["reset_states"] = [env.reset(4, g)]
    elif case == "wrapped_act_fn":
        # an act_fn of the caller's own, its actor not named
        args["actor"] = None
    elif case == "cpu":
        args["env_state"] = env.reset(4, g)
    assert collector.rollout_form(**args) == "loop"


@pytest.mark.parametrize("task", ["SafetyDroneRun-v0", "SafetyAntRun-v0",
                                  "SafetyPointGoal1-v0",
                                  "SafetyCarGoal1-v0"])
def test_other_envs_take_the_loop(task):
    env = make(task)
    assert _form(_algo("ppo_lag", env), env) == "loop"


@pytest.mark.parametrize("name", ["ppo_lag", "focops", "trpo_lag", "cpo"])
def test_the_on_policy_algorithms_name_the_actor_act_fn_samples(name):
    """``rollout_actor`` is the actor whose ``dist.sample`` ``act_fn``
    returns: from one generator state, its mean plus its std times the
    actions' ``randn`` is ``act_fn``'s action, bit for bit."""
    env = make("SafetyCarCircle-v0")
    algo = _algo(name, env)
    params = algo.init(0).params
    obs = env.reset_vec(16, torch.Generator().manual_seed(1)).obs
    act, logp = algo.act_fn(params, obs, torch.Generator().manual_seed(2))
    dist = algo.rollout_actor(params)(obs)
    noise = torch.randn(act.shape, generator=torch.Generator().manual_seed(2))
    assert algo.rollout_actor(params) is params.actor
    assert torch.equal(act, dist.mean + dist.std * noise)
    assert torch.equal(logp, dist.log_prob(act))


def test_a_cpu_rollout_counts_a_loop():
    env = make("SafetyBallRun-v0")
    algo = _algo("ppo_lag", env)
    g = torch.Generator().manual_seed(0)
    collector.ROLLOUTS.clear()
    rollout = collector.make_rollout_fn(env, algo.act_fn, 4, "cpu",
                                        actor=algo.rollout_actor)
    rollout(algo.init(0).params, env.reset_vec(8, g),
            EpisodeStats.init(8, env.num_costs), g)
    assert collector.ROLLOUTS == {"loop": 1}


# --- the reset split: _init_sim == _init_sim_from(_reset_draws) ---------

def _init_sim_before(env, n, g):
    """The car's and the ball's ``_init_sim`` as written before the split:
    each draw made where its value is used."""
    task = env.task
    if type(env).__name__ == "CarEnv":
        if isinstance(task, CircleTask):
            theta = uniform(n, 0.0, 2 * math.pi, g)
            pos = task.radius * torch.stack(
                [torch.cos(theta), torch.sin(theta)], 1)
            pos[:, 0] = torch.clamp(pos[:, 0], -task.x_lim, task.x_lim)
            heading = theta + math.pi / 2
        else:
            pos = uniform((n, 2), -0.5, 0.5, g)
            heading = uniform(n, -0.3, 0.3, g)
        return dict(pos=pos, heading=heading,
                    speed=torch.zeros_like(heading))
    if isinstance(task, CircleTask):
        theta = uniform(n, 0.0, 2 * math.pi, g)
        r = task.radius + uniform(n, -0.5, 0.5, g)
        pos = r[:, None] * torch.stack([torch.cos(theta), torch.sin(theta)],
                                       1)
        pos[:, 0] = torch.clamp(pos[:, 0], -task.x_lim, task.x_lim)
        return dict(pos=pos, vel=torch.zeros_like(pos))
    return dict(pos=uniform((n, 2), -0.5, 0.5, g),
                vel=uniform((n, 2), -0.1, 0.1, g))


def _leaves(x):
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, dict):
        return [y for v in x.values() for y in _leaves(v)]
    if isinstance(x, (list, tuple)):
        return [y for v in x for y in _leaves(v)]
    return [y for v in vars(x).values() for y in _leaves(v)]


@pytest.mark.parametrize("task", KERNEL_TASKS)
def test_the_loops_segment_is_what_it_was_before_the_reset_split(task):
    """A CPU segment of 40 steps of 64 envs, staggered so that some reset,
    equals bit for bit the one stepped with the unsplit reset."""
    out = []
    for split in (True, False):
        env = make(task)
        if not split:
            env._init_sim = lambda n, g, env=env: _init_sim_before(env, n, g)
        algo = _algo("ppo_lag", env)
        g = torch.Generator().manual_seed(5)
        s0 = env.reset_vec(64, g, stagger=True)
        res = collector.make_rollout_fn(env, algo.act_fn, 40, "cpu")(
            algo.init(0).params, s0, EpisodeStats.init(64, env.num_costs), g)
        assert int(res.stats.n_episodes) > 0
        out.append(_leaves((s0, res.env_state, res.stats, res.transitions)))
    assert len(out[0]) == len(out[1])
    for a, b in zip(*out):
        assert torch.equal(a, b)
