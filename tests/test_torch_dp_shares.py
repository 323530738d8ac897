"""Data-parallel PPO-Lag against one process whose grad step runs on the
rows each rank owns (``chip_smoke.py``'s ``_shares``), on the CPU: two
gloo ranks (this file run as a script, each under a timeout) and the one
process agree bit for bit after an iteration at ``dp_blocks`` 2 (each
minibatch's halves) and at ``dp_blocks`` 1 (the global shuffle, uneven
shares). The card runs the same check on K2 (``phase_dp``).

The ranks meet through a file store in the test's own directory, not a
TCP port: a port found free and released before rank 0 binds it can be
taken in between by a socket of the tests that run beside this one
(``-n 6``), and rank 0 then fails. ``init_multihost``'s TCP rendezvous is
tested in ``tests/test_torch_parallel.py``."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
N_ENVS, T_STEPS, TIMEOUT = 64, 16, 240


def _trainer(blocks: int, seed: int, mesh=None):
    from fsrl_torch.agent import PPOLagAgent
    from fsrl_torch.trainer import OnpolicyTrainer
    agent = PPOLagAgent("SafetyCarCircle-v0", cost_limit=10.0, repeat=2,
                        n_minibatches=4, dp_blocks=blocks, seed=seed,
                        device="cpu")
    return OnpolicyTrainer(agent.algo, agent.env, None, n_envs=N_ENVS,
                           steps_per_collect=T_STEPS, cost_limit=10.0,
                           seed=seed, verbose=False, mesh=mesh,
                           state=agent.state)


@pytest.mark.parametrize("blocks,seed", [(2, 3), (1, 3), (1, 4)])
def test_ranks_equal_one_process_on_their_shares(tmp_path, blocks, seed):
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    torch.set_num_threads(1)
    store = str(tmp_path / "store")
    outs = [tmp_path / f"rank{r}.pt" for r in range(2)]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), store, str(blocks), str(seed),
         str(outs[r])], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    for p in procs:
        out, _ = p.communicate(timeout=TIMEOUT)
        assert p.returncode == 0, out[-3000:]
    ranks = [torch.load(o) for o in outs]
    one = _trainer(blocks, seed)
    chip_smoke._shares(one)()
    assert torch.equal(ranks[0], ranks[1])
    assert torch.equal(ranks[0], one.state.flat)


if __name__ == "__main__":
    rank, store, blocks, seed, out = sys.argv[1:6]
    torch.set_num_threads(1)
    import torch.distributed as dist

    from fsrl_torch.parallel.mesh import make_multihost_mesh
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=2, rank=int(rank))
    tr = _trainer(int(blocks), int(seed), make_multihost_mesh(device="cpu"))
    tr._run_iter()
    torch.save(tr.state.flat.clone(), out)
