"""What the CUDA graphs of ``fsrl_torch/trainer/graphs.py`` rest on, on the
CPU: the carry's flatten and rebuild, the aliasing-safe copies into the
captured inputs, the replay buffer written at device indices, and every
trainer's eager cycle free of what a capture refuses (a value read back to
the host, a copy from the host, a data-dependent shape). The graphs
themselves run on the card only: ``tests/test_torch_cuda.py`` and
``chip_smoke.py``'s ``[graph ...]`` phases hold them to the eager
cycles."""

import dataclasses
import traceback
from typing import NamedTuple

import pytest
import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode

import fsrl_torch.algos.cpo as tcpo
from fsrl_torch.agent import (CPOAgent, CVPOAgent, DDPGLagAgent, FOCOPSAgent,
                              PPOLagAgent, RecurrentPPOLagAgent, SACLagAgent,
                              TRPOLagAgent)
from fsrl_torch.data.buffer import ReplayBuffer
from fsrl_torch.trainer import OffpolicyTrainer, OnpolicyTrainer
from fsrl_torch.trainer.graphs import assign, distinct, flatten, rebuild
from fsrl_torch.types import Transition

torch.set_num_threads(1)


@dataclasses.dataclass
class Inner:
    a: torch.Tensor
    n: int


class Pair(NamedTuple):
    x: torch.Tensor
    y: object


def _tree():
    m = nn.Linear(2, 2)
    return dict(s=Inner(torch.zeros(3), 4), p=Pair(torch.ones(2, 2), m),
                l=[torch.arange(3), None, "k", 1.5])


def test_flatten_and_rebuild_round_trip():
    tree = _tree()
    leaves, spec = flatten(tree)
    assert len(leaves) == 3 and leaves[0] is tree["s"].a
    new = [x + 1 for x in leaves]
    out = rebuild(tree, new)
    assert out["s"].a is new[0] and out["s"].n == 4
    assert isinstance(out["p"], Pair) and out["p"].y is tree["p"].y
    assert out["l"][1:] == [None, "k", 1.5]
    assert flatten(out)[1] == spec
    # a static value, a shape or another module is another graph
    other = rebuild(tree, leaves)
    other["s"] = Inner(torch.zeros(3), 5)
    assert flatten(other)[1] != spec
    assert flatten(dict(tree, l=[torch.arange(4), None, "k", 1.5]))[1] != \
        spec
    assert flatten(dict(tree, p=Pair(torch.ones(2, 2), nn.Linear(2, 2))))[
        1] != spec
    with pytest.raises(TypeError, match="cannot hold"):
        flatten({"g": torch.Generator()})
    with pytest.raises(ValueError):
        rebuild(tree, leaves + [torch.zeros(1)])


def test_assign_reads_every_source_before_writing():
    a, b, c = torch.tensor([1.0]), torch.tensor([2.0]), torch.tensor([3.0])
    # swapped: each source is the other destination
    assign([a, b], [b, a])
    assert (a.item(), b.item()) == (2.0, 1.0)
    # a view of a destination, and a tensor copied onto itself
    base = torch.tensor([5.0, 6.0])
    assign([base, c], [base, base[1:]])
    assert c.item() == 6.0 and base.tolist() == [5.0, 6.0]


def test_distinct_clones_shared_memory():
    x = torch.zeros(2)
    tree = dict(a=x, b=x, c=x[1:], d=torch.ones(1))
    out = distinct(tree)
    assert out["a"] is x and out["d"] is tree["d"]
    assert out["b"] is not x and out["c"] is not x
    out["a"].add_(1)
    assert out["b"].tolist() == [0.0, 0.0] and out["c"].tolist() == [0.0]


def test_buffer_writes_at_device_indices():
    """The segment lands at rows ``(pos + t) % C`` (the ring's slices),
    the cursor is a device scalar, and the newest row ends its episodes in
    the n-step view."""
    C, N, T = 5, 2, 3
    buf = ReplayBuffer(C, N, "cpu")
    st = buf.init(1, 1, 1)
    ref = torch.zeros(C, N)
    for i in range(4):
        r = torch.full((T, N), float(i + 1))
        tr = Transition(obs=r[..., None], act=r[..., None],
                        obs_next=r[..., None], reward=r,
                        cost=r[..., None], terminated=r < 0,
                        truncated=r < 0, logp=r)
        pos = int(st.pos)
        for t in range(T):
            ref[(pos + t) % C] = r[t]
        st = buf.add_segment(st, tr)
        assert st.pos.dtype == torch.long and st.pos.dim() == 0
        assert int(st.pos) == (pos + T) % C
        assert st.filled == min((i + 1) * T, C)
        assert torch.equal(st.data.reward, ref)
    ends = buf.end_flag_flat(st).view(C, N)
    assert ends[(int(st.pos) - 1) % C].all() and ends.sum() == N


SYNC_OPS = {"aten._local_scalar_dense.default", "aten.nonzero.default",
            "aten.lift_fresh.default", "aten.masked_select.default",
            "aten.item.default", "aten.is_nonzero.default",
            "aten.equal.default"}


class HostReads(TorchDispatchMode):
    """Records the ops a CUDA graph's capture refuses: a read of a device
    value on the host, a copy from the host (a tensor made from Python
    data), and the data-dependent shapes (``nonzero``, boolean masks,
    ``unique``, ``repeat_interleave``)."""

    def __init__(self):
        super().__init__()
        self.hits = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        bad = (name in SYNC_OPS or name.startswith("aten.unique")
               or name.startswith("aten.repeat_interleave"))
        if name.startswith("aten.index"):
            bad |= any(isinstance(t, torch.Tensor) and t.dtype == torch.bool
                       for a in args if isinstance(a, (list, tuple))
                       for t in a)
        if bad:
            self.hits.append((name, "".join(traceback.format_stack(
                limit=6)[:-1])))
        return func(*args, **(kwargs or {}))


CYCLES = [(PPOLagAgent, "SafetyCarCircle-v0"),
          (FOCOPSAgent, "SafetyCarCircle-v0"),
          (TRPOLagAgent, "SafetyDroneRun-v0"),
          (CPOAgent, "SafetyAntRun-v0"),
          (RecurrentPPOLagAgent, "SafetyPointGoal1-v0"),
          (PPOLagAgent, "SafetyCarPush1-v0"),
          (PPOLagAgent, "SafetyPointButton1-v0"),
          (DDPGLagAgent, "SafetyBallCircle-v0"),
          (SACLagAgent, "SafetyBallCircle-v0"),
          (CVPOAgent, "SafetyBallCircle-v0")]


@pytest.mark.parametrize("agent_cls,task", CYCLES,
                         ids=[f"{c.__name__}-{t}" for c, t in CYCLES])
def test_cycle_has_nothing_a_capture_refuses(monkeypatch, agent_cls, task):
    """One eager cycle of each trainer, after a first one (which makes the
    envs' constants), runs no op a capture refuses; CPO's line search
    under a capture keeps its choice on the device."""
    monkeypatch.setattr(tcpo, "capturing", lambda: True)
    kw = dict(batch_size=16) if agent_cls in (
        DDPGLagAgent, SACLagAgent, CVPOAgent) else {}
    agent = agent_cls(task, cost_limit=10.0, seed=0, device="cpu", **kw)
    if agent.onpolicy:
        tr = OnpolicyTrainer(agent.algo, agent.env, None, n_envs=8,
                             steps_per_collect=16, state=agent.state,
                             verbose=False)
    else:
        tr = OffpolicyTrainer(agent.algo, agent.env, None, n_envs=4,
                              steps_per_collect=16, state=agent.state,
                              verbose=False, update_per_step=0.25,
                              buffer_size=1000)
    tr.cycle()
    with HostReads() as reads:
        tr.cycle()
    assert not reads.hits, "\n".join(f"{n}\n{s}" for n, s in reads.hits)


@pytest.mark.parametrize("fuse,chunk,mode", [
    (2, 32, "eager (on the CPU)"), (1, 8, "eager (on the CPU)"),
    (1, 1, "eager")], ids=["fuse", "chunk", "plain"])
def test_trainers_log_their_dispatch_mode(caplog, fuse, chunk, mode):
    """Each trainer logs its dispatch mode once, on its module's logger."""
    caplog.set_level("INFO", logger="fsrl_torch.trainer.trainer")
    agent = SACLagAgent("SafetyBallCircle-v0", cost_limit=10.0, seed=0,
                        device="cpu", batch_size=16)
    tr = OffpolicyTrainer(agent.algo, agent.env, None, n_envs=4,
                          steps_per_collect=16, state=agent.state,
                          verbose=False, update_per_step=0.25,
                          buffer_size=1000, fuse_iters=fuse,
                          update_chunk=chunk)
    assert tr.dispatch_mode == mode
    assert [r.getMessage() for r in caplog.records] == [
        f"OffpolicyTrainer 4 envs x 16 steps, fuse_iters {fuse}: {mode}"]
