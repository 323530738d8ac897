"""The port's data-parallel layer (``fsrl_torch/parallel/mesh.py``) on the
CPU, the counterpart of ``tests/test_parallel.py`` and
``tests/test_multihost.py``: two gloo ranks (``tests/_torch_dp_worker.py``,
each under its own timeout) run the cases of ``tests/_torch_dp_cases.py``
from JAX's initial weights, and the test process runs the same cases in one
process. The block-local shuffle (``dp_blocks``) is held to JAX's."""

import os
import random
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (n, rollout_transitions, state_dict, t,
                           transition)

import _torch_dp_cases as cases
from fsrl_tpu.algos.focops import FOCOPS as JFOCOPS
from fsrl_tpu.algos.ppo_lag import PPOLag as JPPOLag
from fsrl_torch.algos.focops import FOCOPS
from fsrl_torch.algos.ppo_lag import PPOLag
from fsrl_torch.envs import make
from fsrl_torch.types import TileLayout, minibatch_row_index
from fsrl_torch.utils.params import to_jax_params

torch.set_num_threads(1)

WORLD = 2
WORKER_TIMEOUT = 240     # seconds a rank may take; a hung collective fails
# tests/test_parallel.py's tolerance for parameters after one train step
RTOL, ATOL = 2e-4, 2e-5


def _free_port() -> int:
    """A free TCP port below the kernel's ephemeral range, for rank 0's
    store. Rank 0 binds it seconds after this check; an ephemeral port
    found free could be handed out in that gap to a socket of the tests
    running beside this one (gloo's pairs and stores, ``-n 6``), and rank
    0 would then fail. The kernel hands out no port below its range."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low = int(f.read().split()[0])
    except OSError:
        low = 32768
    rng = random.Random()
    for _ in range(200):
        port = rng.randrange(max(1024, low - 10000), low)
        with socket.socket() as s:
            try:
                s.bind(("localhost", port))
            except OSError:
                continue
        return port
    raise RuntimeError("no free port below the ephemeral range")


def _launch(mode: str, src: str, dst: str) -> list:
    worker = os.path.join(os.path.dirname(__file__), "_torch_dp_worker.py")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    port = str(_free_port())
    return [subprocess.Popen(
        [sys.executable, worker, mode, str(r), str(WORLD), port, src,
         dst.format(r)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env) for r in range(WORLD)]


def _wait(procs: list, dst: str) -> list[dict]:
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=WORKER_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"a rank ran past {WORKER_TIMEOUT} s")
        outs.append(out)
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    return [dict(np.load(dst.format(r))) for r in range(WORLD)]


def _weights() -> dict:
    """Every case's initial weights: JAX's PPO-Lag initialization for the
    actor-critic cases, the port's own for the recurrent one."""
    out = {}
    for case, (task, cls, _) in cases.ONPOLICY.items():
        if case == "ppo_lag_rnn":
            w = cases.init_weights(case)
        else:
            env = make(task)
            jalgo = JPPOLag(env.observation_size, env.action_size)
            w = {k: n(v) for k, v in state_dict(
                jax.jit(jalgo.init)(jax.random.PRNGKey(0)).params).items()}
        out.update({f"{case}/{k}": v for k, v in w.items()})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(one process, [rank 0, rank 1], [multihost rank 0, rank 1])``."""
    d = tmp_path_factory.mktemp("dp")
    weights = _weights()
    src = str(d / "in.npz")
    np.savez(src, **weights)
    dst, dst_mh = str(d / "out{}.npz"), str(d / "mh{}.npz")
    procs = _launch("cases", src, dst)
    procs_mh = _launch("multihost", "-", dst_mh)
    one = cases.run_all(weights)
    return one, _wait(procs, dst), _wait(procs_mh, dst_mh)


def _columns(x: np.ndarray, rank: int) -> np.ndarray:
    """Rank ``rank``'s block of the env axis (axis 1) of a time-major or
    buffer array."""
    per = x.shape[1] // WORLD
    return x[:, rank * per:(rank + 1) * per]


# each algorithm's loss, held to 1e-3 as tests/test_parallel.py holds
# PPO-Lag's loss/total
LOSS = {"focops_dp_blocks_2": "loss/actor_loss",
        "trpo_lag": "loss/loss_actor_total", "cpo": "loss/vf_total"}


def _check_step(one: dict, ranks: list[dict], case: str) -> None:
    get = lambda d, k: d[f"{case}/{k}"]
    # the ranks hold one replica: equal bit for bit
    for r in ranks[1:]:
        assert np.array_equal(get(ranks[0], "flat"), get(r, "flat"))
    # each rank's segment is its columns of the one-process segment, bit
    # for bit (the policy runs on the global batch, every draw is global)
    tr_keys = [k[len(case) + 1:] for k in one if k.startswith(f"{case}/tr/")]
    for r, res in enumerate(ranks):
        for k in tr_keys:
            assert np.array_equal(get(res, k), _columns(get(one, k), r)), k
    np.testing.assert_allclose(get(ranks[0], "flat"), get(one, "flat"),
                               rtol=RTOL, atol=ATOL)
    loss = "metric/" + LOSS.get(case, "loss/total")
    assert float(get(ranks[0], loss)) == pytest.approx(
        float(get(one, loss)), rel=1e-3)
    assert int(get(ranks[0], "gradient_steps")) == int(
        get(one, "gradient_steps"))
    assert int(get(ranks[0], "n_episodes")) == int(get(one, "n_episodes"))
    if f"{case}/metric/update/early_stopped" in one:
        assert float(get(ranks[0], "metric/update/early_stopped")) == float(
            get(one, "metric/update/early_stopped"))


@pytest.mark.parametrize("case", [c for c in cases.ONPOLICY if c != "cpo"])
def test_train_step_matches_one_process(runs, case):
    """One collect and update on 2 ranks against one process: PPO-Lag with
    the global shuffle (``dp_blocks`` 1, uneven shares), the block-local
    one (2), a KL early stop, return normalization, the one-pass critic
    with truncations, a navigation env, FOCOPS, TRPO-Lag (the same
    backtracks) and recurrent PPO-Lag."""
    one, ranks, _ = runs
    _check_step(one, ranks, case)
    if case == "ppo_lag_one_pass":
        assert int(one[f"{case}/tr/truncated"].sum()) >= cases.N
        # each rank's advantages and returns are its env-major rows of one
        # process's, bit for bit: the truncated rows' values come from one
        # gather over both ranks' envs, each row in its one-process place
        rows = cases.N // WORLD * cases.T
        for r, res in enumerate(ranks):
            for k in ("adv", "ret"):
                np.testing.assert_array_equal(
                    res[f"{case}/batch/{k}"],
                    one[f"{case}/batch/{k}"][r * rows:(r + 1) * rows])
    if case == "ppo_lag_early_stop":
        assert float(one[f"{case}/metric/update/early_stopped"]) == 1.0
    if case == "trpo_lag":
        for r in ranks:
            assert np.array_equal(r[f"{case}/backtracks"],
                                  one[f"{case}/backtracks"])


def test_cpo_step_matches_one_process(runs):
    """CPO: the CG products, line search and dual solve stay global, so
    every rank takes the one-process branch (tests/test_parallel.py:139)."""
    one, ranks, _ = runs
    _check_step(one, ranks, "cpo")
    for r in ranks:
        assert float(r["cpo/metric/loss/optim_case"]) == float(
            one["cpo/metric/loss/optim_case"])
        for k in ("step_size", "kl"):
            np.testing.assert_allclose(r[f"cpo/metric/loss/{k}"],
                                       one[f"cpo/metric/loss/{k}"],
                                       rtol=2e-3, atol=1e-5)


def test_global_episode_stats(runs):
    """Every env truncates once in ``max_episode_steps + 2`` steps: the
    merged count is N on every rank, each rank having seen its own half."""
    one, ranks, _ = runs
    assert int(one["stats/n_episodes"]) == cases.N
    for r in ranks:
        assert int(r["stats/n_episodes"]) == cases.N
        assert int(r["stats/local_episodes"]) == cases.N // WORLD
        assert int(r["stats/n_steps"]) == int(one["stats/n_steps"])


def test_offpolicy_trainer_matches_one_process_bit_for_bit(runs):
    """SAC-Lag through the off-policy trainer, 3 iterations: each rank's
    buffer holds its columns of the one-process buffer, and the assembled
    batches make every parameter equal to the one-process run's."""
    one, ranks, _ = runs
    for r, res in enumerate(ranks):
        for k in ("flat", "target", "log_alpha", "multiplier"):
            assert np.array_equal(res[f"sac_lag/{k}"], one[f"sac_lag/{k}"]), k
        for k in [k for k in one if k.startswith("sac_lag/buf/")]:
            assert np.array_equal(res[k], _columns(one[k], r)), k


def test_trainer_tests_on_rank0(runs):
    """The on-policy trainer's epoch: the test runs on rank 0, and every
    rank leaves with its results and generator state."""
    one, ranks, _ = runs
    for r in ranks:
        assert int(r["trainer/env_step"]) == int(one["trainer/env_step"])
        assert np.array_equal(r["trainer/generator"],
                              one["trainer/generator"])
        assert float(r["trainer/test_reward"]) == float(
            ranks[0]["trainer/test_reward"])
        np.testing.assert_allclose(r["trainer/flat"], one["trainer/flat"],
                                   rtol=RTOL, atol=ATOL)
    assert float(ranks[0]["trainer/test_reward"]) == pytest.approx(
        float(one["trainer/test_reward"]), rel=1e-3)


def test_multihost_over_tcp(runs):
    """``init_multihost`` over TCP on 2 processes: the flat and the
    ``("host", "dp")`` meshes, and one PPO-Lag train step with the same
    loss on both (tests/test_multihost.py)."""
    _, _, mh = runs
    for r in mh:
        assert int(r["world"]) == WORLD
        assert tuple(r["flat_shape"]) == (WORLD,)
        assert tuple(r["flat_names"]) == ("dp",)
        assert tuple(r["hier_shape"]) == (WORLD, 1)
        assert tuple(r["hier_names"]) == ("host", "dp")
        assert "Shard(dim=0)" in str(r["placements"][0])
        assert str(r["placements"][1]).count("Replicate()") == 2
        assert np.isfinite(float(r["loss"]))
    assert float(mh[0]["loss"]) == float(mh[1]["loss"])
    assert np.array_equal(mh[0]["flat_params"], mh[1]["flat_params"])


# ---------------------------------------------------------------------------
# The block-local shuffle against JAX's (one process)
# ---------------------------------------------------------------------------

D, A = 6, 2


def _jax_block_perms(rng, layout, n_epochs, per_epoch):
    """The tile permutations ``(n_epochs, n_blocks, usable)`` and roll
    offset(s) JAX's shuffle draws from ``rng`` with ``n_blocks``:
    ``minibatch_epochs_scan`` (one key for all epochs) or, with
    ``per_epoch``, ``minibatch_scan`` on one key per epoch."""
    nb = layout.n_blocks

    def one_call(key, n_ep):
        _, k_perm, k_roll = jax.random.split(key, 3)
        keys = jax.random.split(k_perm, n_ep * nb).reshape(n_ep, nb, -1)
        perms = jax.vmap(jax.vmap(lambda k: jax.random.permutation(
            k, layout.n_tiles)[: layout.usable]))(keys)
        roll = (int(jax.random.randint(k_roll, (), 0, layout.size))
                if layout.needs_roll else 0)
        return np.asarray(perms), roll

    if not per_epoch:
        perms, roll = one_call(rng, n_epochs)
        return torch.from_numpy(perms.copy()).long(), torch.tensor(roll)
    got = [one_call(k, 1) for k in jax.random.split(rng, n_epochs)]
    return (torch.from_numpy(np.concatenate([p for p, _ in got])).long(),
            torch.tensor([r for _, r in got]))


def test_block_row_index_matches_jax():
    """The port's block-local row index gives the rows JAX's
    ``minibatch_epochs_scan(..., n_blocks=2)`` gives for the same key:
    300 rows (tile 1) and 8200 (tile 2, 4 rows a block left over: the
    roll)."""
    from fsrl_tpu.types import minibatch_epochs_scan
    for size in (300, 8200):
        rng = jax.random.PRNGKey(4)
        batch = {"i": jnp.arange(size, dtype=jnp.int32)[:, None]}
        _, rows_j = minibatch_epochs_scan(
            rng, batch, 3, 2, lambda c, mb, e: (c, mb["i"][:, 0]),
            jnp.zeros(()), n_blocks=2, per_leaf=True)
        layout = TileLayout.of(size, 2, n_blocks=2)
        perms, roll = _jax_block_perms(rng, layout, 3, per_epoch=False)
        rows_t = minibatch_row_index(layout, perms, roll)
        np.testing.assert_array_equal(n(rows_t), np.asarray(rows_j))
        # every minibatch takes the same number of rows from both blocks
        if not layout.needs_roll:
            assert bool(((rows_t < size // 2).sum(1) == layout.mb_rows // 2)
                        .all())


@pytest.mark.parametrize("algo", ["ppo_lag", "focops"])
def test_dp_blocks_update_matches_jax(algo):
    """One update with ``dp_blocks`` 2 on one process against JAX's
    ``dp_blocks=2`` update, with JAX's block-local permutations; the
    tolerances of test_torch_ppo_lag.py and test_torch_focops.py."""
    T, N = 16, 32
    kw = dict(repeat=2, n_minibatches=2, cost_limit=5.0, dp_blocks=2)
    jtr = rollout_transitions(T, N, D, A, seed=2)
    jcls, tcls = (JPPOLag, PPOLag) if algo == "ppo_lag" else (JFOCOPS,
                                                              FOCOPS)
    jalgo = jcls(D, A, **kw, **({"gae_impl": "scan"}
                                if algo == "ppo_lag" else {}))
    talgo = tcls(D, A, device="cpu", **kw)
    jstate = jax.jit(jalgo.init)(jax.random.PRNGKey(0))
    tstate = talgo.init(state_dict=state_dict(jstate.params))
    params = jstate.params
    rng = jax.random.PRNGKey(5)
    jnew, jm = jax.jit(jalgo.update)(jstate, jtr, jnp.asarray([7.0]),
                                     jnp.asarray(3, jnp.int32), rng)
    layout = TileLayout.of(T * N, 2, n_blocks=2)
    perms = _jax_block_perms(rng, layout, 2, per_epoch=algo == "focops")
    assert perms[0].shape == (2, 2, layout.usable)
    tnew, tm = talgo.update(tstate, transition(jtr), t(np.float32([7.0])),
                            torch.tensor(3, dtype=torch.int32), None,
                            perms=perms)
    assert set(tm) == set(jm)
    for k in jm:
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-4,
                                             abs=1e-6), k
    assert int(tnew.gradient_steps) == int(jnew.gradient_steps)
    jp = jax.tree.leaves(jax.device_get(jnew.params))
    tp = jax.tree.leaves(to_jax_params(tnew.params.state_dict()))
    worst = max(float(np.abs(a - np.asarray(b)).max())
                for a, b in zip(tp, jp))
    assert worst < 1e-5, worst
