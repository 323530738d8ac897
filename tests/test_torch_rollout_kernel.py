"""The rollout kernel (``csrc/rollout.cu``) against the collector's loop on
the card. These need an NVIDIA GPU with ``nvcc`` and skip elsewhere; run
them on the card with

    python -m pytest --noconftest tests/test_torch_rollout_kernel.py -m cuda -q

Both forms draw from one generator state, so they see the same noise and
reset draws. The loop runs where the rollout is given no ``actor``; the
kernel where it is given the algorithm's ``rollout_actor``. Each test runs
at both of the kernel's widths, two ReLU layers of 128 or of 256 units.
"""

import pytest
import torch

from fsrl_torch.ops import kernels

pytestmark = pytest.mark.cuda

TASKS = ["SafetyCarCircle-v0", "SafetyCarRun-v0", "SafetyBallCircle-v0",
         "SafetyBallRun-v0", "SafetyBallCircle2C-v0"]
N, T = 4096, 64
HIDDEN = [128, 256]
# The actor's products are f32 FMAs summed in another order than cuBLAS's:
# actions differ in the last bits and the states integrate that over the
# 64 steps (the largest difference read on the card is about 1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _setup(task, cuda, n=N, hidden=128):
    from fsrl_torch.algos.ppo_lag import PPOLag
    from fsrl_torch.envs import make
    from fsrl_torch.types import EpisodeStats
    env = make(task)
    algo = PPOLag(env.observation_size, env.action_size,
                  num_costs=env.num_costs, device=cuda,
                  hidden_sizes=(hidden, hidden))
    state = algo.init(seed=0)
    g = torch.Generator(device=cuda).manual_seed(7)
    # staggered clocks: about an eighth of the envs reset in 64 steps
    s0 = env.reset_vec(n, g, stagger=True)
    return env, algo, state, s0, EpisodeStats.init(n, env.num_costs, cuda), g


def _both(task, cuda, hidden, given_actions=False):
    """The loop's and the kernel's segment from one generator state; with
    ``given_actions`` the kernel takes the loop's actions and log-probs in
    place of its actor."""
    from fsrl_torch.data import collector
    from fsrl_torch.ops.rollout_kernel import rollout_segment
    env, algo, state, s0, stats, g = _setup(task, cuda, hidden=hidden)
    start = g.get_state()
    loop = collector.make_rollout_fn(env, algo.act_fn, T)
    ref = loop(state.params, s0, stats, g)
    g.set_state(start)
    actions = ((ref.transitions.act, ref.transitions.logp) if given_actions
               else None)
    env_state, st, tr = rollout_segment(env, state.params.actor, s0, stats,
                                        g, T, actions=actions)
    return ref, env_state, st, tr


def _equal(name, a, b):
    assert a.shape == b.shape and a.dtype == b.dtype, name
    diff = a != b
    assert not diff.any(), (
        f"{name}: {int(diff.sum())} of {a.numel()} differ, first at "
        f"{[int(i) for i in diff.nonzero()[0]]}: {a[diff][:4].tolist()} "
        f"against {b[diff][:4].tolist()}")


def _close(name, a, b):
    torch.testing.assert_close(a, b, **TOL, msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("hidden", HIDDEN)
@pytest.mark.parametrize("task", TASKS)
def test_rollout_kernel_matches_the_loop(cuda, task, hidden):
    """Equal bit for bit: the clocks, the done flags, the cost channels
    and the counts; within TOL (the actor's sum order): the actions,
    log-probs, observations, rewards and the sim state."""
    ref, env_state, st, tr = _both(task, cuda, hidden)
    rt = ref.transitions
    for name in ("terminated", "truncated", "cost"):
        _equal(name, getattr(tr, name), getattr(rt, name))
    _equal("t", env_state.t, ref.env_state.t)
    for name in ("n_episodes", "n_steps", "n_terminated", "n_truncated",
                 "sum_cost", "sum_len", "ep_len", "ep_cost"):
        _equal(name, getattr(st, name), getattr(ref.stats, name))
    assert int(st.n_episodes) > 0
    for name in ("act", "logp", "obs", "obs_next", "reward"):
        _close(name, getattr(tr, name), getattr(rt, name))
    for k, v in ref.env_state.sim.items():
        _close(k, env_state.sim[k], v)
    _close("obs", env_state.obs, ref.env_state.obs)
    _close("sum_reward", st.sum_reward, ref.stats.sum_reward)
    _close("ep_reward", st.ep_reward, ref.stats.ep_reward)


@pytest.mark.parametrize("hidden", HIDDEN)
@pytest.mark.parametrize("task", TASKS)
def test_rollout_kernel_steps_the_loops_actions_bit_for_bit(cuda, task,
                                                            hidden):
    """With the loop's actions in place of the actor, the env, the resets
    and the accumulators are the loop's bit for bit; only the episode
    reward sum, a sum over the envs in another order than ATen's, may
    differ in its last bits."""
    ref, env_state, st, tr = _both(task, cuda, hidden, given_actions=True)
    for name, x in vars(tr).items():
        _equal(name, x, getattr(ref.transitions, name))
    for k, v in ref.env_state.sim.items():
        _equal(k, env_state.sim[k], v)
    _equal("obs", env_state.obs, ref.env_state.obs)
    _equal("t", env_state.t, ref.env_state.t)
    for name, x in vars(st).items():
        if name == "sum_reward":
            # the finished episodes' returns, summed in another order than
            # ATen's: within 1e-6 of the sum of their magnitudes, which the
            # segment's rewards bound (the returns start at 0)
            scale = ref.transitions.reward.abs().sum()
            assert (x - ref.stats.sum_reward).abs() <= 1e-6 * scale
        else:
            _equal(name, x, getattr(ref.stats, name))


@pytest.mark.parametrize("hidden", HIDDEN)
def test_rollout_kernel_replays_its_eager_call(cuda, hidden):
    """A graph of two kernel segments (``graphs.Dispatch``) replays what
    the eager calls compute, bit for bit, and counts its launch and its
    rollouts where it runs the Python code: the eager warm-up and the
    capture."""
    from fsrl_torch.data import collector
    from fsrl_torch.trainer.graphs import Dispatch
    env, algo, state, s0, stats, g = _setup("SafetyCarCircle-v0", cuda,
                                            n=1000, hidden=hidden)
    rollout = collector.make_rollout_fn(env, algo.act_fn, 40,
                                        actor=algo.rollout_actor)

    def two(carry, params):
        env_state, stats = carry
        trs = []
        for _ in range(2):
            res = rollout(params, env_state, stats.reset_aggregates(), g)
            env_state, stats = res.env_state, res.stats
            trs.append(res.transitions)
        return (env_state, stats), trs

    start = g.get_state()
    clone = lambda s: type(s)(**{k: (v.clone() if torch.is_tensor(v) else
                                     {a: b.clone() for a, b in v.items()})
                                 for k, v in vars(s).items()})
    carry0 = (clone(s0), clone(stats))
    eager = []
    for _ in range(3):
        carry, trs = two((carry0 if not eager else carry), state.params)
        eager.append((clone(carry[0]), clone(carry[1]), trs))
    g.set_state(start)
    kernels.LAUNCHES.clear()
    collector.ROLLOUTS.clear()
    d = Dispatch(two, (g,), name="two segments")
    carry = (clone(s0), clone(stats))
    for i in range(3):
        carry, trs = d(carry, state.params)
        es, est, etrs = eager[i]
        for name, x in vars(carry[0]).items():
            y = getattr(es, name)
            for k in (x if isinstance(x, dict) else {"": x}):
                _equal(f"{i} {name}{k}", (x[k] if k else x),
                       (y[k] if k else y))
        for name, x in vars(carry[1]).items():
            _equal(f"{i} {name}", x, getattr(est, name))
        for a, b in zip(trs, etrs):
            for name, x in vars(a).items():
                _equal(f"{i} {name}", x, getattr(b, name))
    assert (d.captures, d.replays) == (1, 2)
    # the warm-up and the capture ran the Python code, two segments each
    assert kernels.LAUNCHES["rollout"] == 4
    assert collector.ROLLOUTS == {"kernel": 4}
    assert dict(d.launches) == {"rollout": 2}


def test_rollout_counts_its_form(cuda):
    """``ROLLOUTS`` counts a kernel rollout for PPO-Lag given its
    ``rollout_actor``, a loop for PPO-Lag given no actor and for SAC-Lag's
    actor (outside the kernel's envelope); ``LAUNCHES["rollout"]`` one a
    kernel rollout."""
    from fsrl_torch.algos.sac_lag import SACLag
    from fsrl_torch.data import collector
    env, algo, state, s0, stats, g = _setup("SafetyBallCircle-v0", cuda,
                                            n=64)
    kernels.LAUNCHES.clear()
    collector.ROLLOUTS.clear()
    collector.make_rollout_fn(env, algo.act_fn, 8, actor=algo.rollout_actor)(
        state.params, s0, stats, g)
    collector.make_rollout_fn(env, algo.act_fn, 8)(state.params, s0, stats,
                                                   g)
    sac = SACLag(env.observation_size, env.action_size, device=cuda)
    collector.make_rollout_fn(env, sac.act_fn, 8, actor=lambda p: p.actor)(
        sac.init(0).params, s0, stats, g)
    assert collector.ROLLOUTS == {"kernel": 1, "loop": 2}
    assert kernels.LAUNCHES["rollout"] == 1


def test_rollout_unroll_on_the_kernel_path_reports_the_kernel(cuda):
    """PPO-Lag on SafetyCarCircle-v0 at ``rollout_unroll`` 4: the kernel
    runs the segment, so the trainer makes no step graph and says so."""
    from fsrl_torch.agent import PPOLagAgent
    from fsrl_torch.data import collector
    from fsrl_torch.trainer import OnpolicyTrainer, graphs
    agent = PPOLagAgent("SafetyCarCircle-v0", cost_limit=10.0, repeat=2,
                        n_minibatches=2)
    tr = OnpolicyTrainer(agent.algo, agent.env, None, n_envs=64,
                         steps_per_collect=16, seed=0, verbose=False,
                         state=agent.state, rollout_unroll=4)
    assert tr.dispatch_mode == "eager; rollout kernel"
    graphs.CAPTURES.clear()
    collector.ROLLOUTS.clear()
    tr._run_iter()
    assert collector.ROLLOUTS == {"kernel": 1}
    assert not graphs.CAPTURES
