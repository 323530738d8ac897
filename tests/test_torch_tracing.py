"""The port's in-memory trace (``fsrl_torch/utils/profiling.py``) on the
CPU: host spans by dispatch, the bounded rings, the switch, the four
marks a cycle of both trainers, no host read added to a dispatch, the
card's ring read and mapped onto the host clock (through a stand-in for
the kernel library), and the trainer's ``collect_time`` from the
spans."""

import ctypes
import time

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from fsrl_torch.agent import PPOLagAgent, SACLagAgent
from fsrl_torch.ops import kernels
from fsrl_torch.trainer import OffpolicyTrainer, OnpolicyTrainer
from fsrl_torch.utils import profiling

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def fresh_trace():
    profiling.enable(True)
    profiling.reset()
    yield
    profiling.enable(True)
    profiling.reset()


def _onpolicy(fuse_iters=1, **kw):
    agent = PPOLagAgent("SafetyCarCircle-v0", cost_limit=10.0, repeat=1,
                        n_minibatches=2, hidden_sizes=(16, 16),
                        device="cpu")
    return OnpolicyTrainer(agent.algo, agent.env, None, n_envs=8,
                           steps_per_collect=8, seed=0, verbose=False,
                           state=agent.state, fuse_iters=fuse_iters, **kw)


def _offpolicy(fuse_iters=1, **kw):
    agent = SACLagAgent("SafetyBallCircle-v0", cost_limit=10.0,
                        batch_size=16, hidden_sizes=(16, 16), device="cpu")
    return OffpolicyTrainer(agent.algo, agent.env, None, n_envs=4,
                            steps_per_collect=10, buffer_size=200,
                            update_per_step=0.1, update_chunk=2, seed=0,
                            verbose=False, state=agent.state,
                            fuse_iters=fuse_iters, **kw)


TRAINERS = {"onpolicy": _onpolicy, "offpolicy": _offpolicy}


@pytest.mark.parametrize("kind", sorted(TRAINERS))
def test_spans_of_a_dispatch_share_its_number_and_nest(kind):
    tr = TRAINERS[kind]()
    for _ in range(3):
        tr._run_iter()
    rec = profiling.record()
    assert rec.dispatches() == [1, 2, 3]
    by_id = {s.id: s for s in rec.spans}
    names = set()
    for s in rec.spans:
        names.add(s.name)
        assert s.start_ns <= s.end_ns
        if s.name == "trainer.dispatch":
            assert s.parent is None
            continue
        top = by_id[s.parent]
        assert top.name == "trainer.dispatch"
        assert s.dispatch == top.dispatch
        assert top.start_ns <= s.start_ns <= s.end_ns <= top.end_ns
    want = {"trainer.dispatch", "trainer.log_readback"}
    if kind == "offpolicy":
        want.add("collector.collect")
    assert names == want


def test_the_rings_stay_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "CAPACITY", 8)
    profiling.reset()
    for i in range(20):
        with profiling.span("s", label=str(i)):
            profiling.mark("cycle.start", torch.device("cpu"))
    rec = profiling.record()
    assert [s.label for s in rec.spans] == [str(i) for i in range(12, 20)]
    assert [m.seq for m in rec.marks] == list(range(12, 20))


def test_nothing_is_recorded_while_capturing_or_off(monkeypatch):
    tr = _onpolicy()
    profiling.enable(False)
    tr._run_iter()
    rec = profiling.record()
    assert rec.spans == [] and rec.marks == [] and rec.dispatches() == []
    profiling.enable(True)
    monkeypatch.setattr(profiling, "capturing", lambda: True)
    with profiling.span("graph body"):
        pass
    assert profiling.record().spans == []


@pytest.mark.parametrize("fuse_iters", [1, 2])
@pytest.mark.parametrize("kind", sorted(TRAINERS))
def test_each_cycle_marks_its_four_boundaries_in_order(kind, fuse_iters):
    tr = TRAINERS[kind](fuse_iters)
    for _ in range(2):
        tr._run_iter()
    marks = profiling.record().marks
    assert [m.name for m in marks] == list(profiling.MARKS) * 2 * fuse_iters
    assert [(m.dispatch, m.cycle) for m in marks] == [
        (d, c) for d in (1, 2) for c in range(fuse_iters) for _ in range(4)]
    times = [m.t_ns for m in marks]
    assert times == sorted(times)


class HostReads(TorchDispatchMode):
    """Counts the ops that read a device value on the host."""

    NAMES = ("aten._local_scalar_dense", "aten.item", "aten.is_nonzero",
             "aten.equal")

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func).startswith(self.NAMES):
            self.count += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kind", sorted(TRAINERS))
def test_tracing_adds_no_host_read_to_a_dispatch(kind):
    counts = []
    for on in (False, True):
        profiling.enable(on)
        tr = TRAINERS[kind](2)
        tr._run_iter()                  # the envs' constants, made once
        with HostReads() as reads:
            tr._run_iter()
        counts.append(reads.count)
    assert counts[0] == counts[1]
    assert profiling.record().marks        # the traced trainer marked


def test_spans_are_profiler_ranges():
    """Under a profiler each span is a host range of its name, and not a
    user annotation (which the profiler copies onto the device's
    timeline)."""
    tr = _onpolicy()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tr._run_iter()
    ranges = {e.name: e for e in prof.events()
              if e.name.startswith("trainer.")}
    assert set(ranges) == {"trainer.dispatch", "trainer.log_readback"}
    assert not any(e.is_user_annotation for e in ranges.values())


class FakeMarksLibrary:
    """The card's half of the trace on the host: a ring of ``capacity``
    24-byte entries written at each mark, and a timer running ``rate``
    times the host clock's speed from ``offset`` ns."""

    def __init__(self, capacity=16, offset=-5 * 10 ** 11, rate=1.00001):
        self.ring = np.zeros(capacity, profiling._ENTRY)
        self.count, self.offset, self.rate = 0, offset, rate
        self.clock_word = 0
        self.capturing = False
        self.pending = []               # marks recorded into a "graph"

    def now(self):
        return int(time.perf_counter_ns() * self.rate) + self.offset

    def fsrl_mark(self, mid, cycle, stream):
        if self.capturing:
            self.pending.append((mid, cycle))
        else:
            self._write(mid, cycle)
        return 0

    def _write(self, mid, cycle):
        self.ring[self.count % len(self.ring)] = (self.count, self.now(),
                                                  mid, cycle)
        self.count += 1

    def replay(self):
        for mid, cycle in self.pending:
            self._write(mid, cycle)

    def fsrl_marks_capacity(self):
        return len(self.ring)

    def fsrl_marks_read(self, ring, count):
        ctypes.memmove(ring, self.ring.ctypes.data, self.ring.nbytes)
        ctypes.memmove(count, np.array([self.count], np.uint64).ctypes.data,
                       8)
        return 0

    def fsrl_marks_clock(self, stream):
        self.clock_word = self.now()
        return 0

    def fsrl_marks_clock_read(self, out):
        ctypes.memmove(out, np.array([self.clock_word],
                                     np.uint64).ctypes.data, 8)
        return 0


class FakeStream:
    cuda_stream = 0

    def synchronize(self):
        pass


def test_card_marks_map_to_the_host_clock_and_their_dispatches(
        monkeypatch):
    """Eager marks and marks replayed from a "graph" come back in order,
    each with its dispatch number, on the host clock within the
    calibration's error, across a ring that wrapped."""
    lib = FakeMarksLibrary()
    monkeypatch.setattr(profiling, "_S", profiling._State())
    monkeypatch.setattr(kernels, "library", lambda: lib)
    monkeypatch.setattr(kernels, "stream_ptr", lambda: 0)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: FakeStream())
    monkeypatch.setattr(profiling, "capturing", lambda: lib.capturing)
    card = torch.device("cuda")
    launched = []                       # (dispatch, name, host ns)

    def eager(name, d):
        launched.append((d, name, time.perf_counter_ns()))
        profiling.mark(name, card)

    profiling.mark("cycle.start", card)         # outside any dispatch
    launched.append((None, "cycle.start", 0))
    with profiling.span("trainer.dispatch", dispatch=True):
        for name in profiling.MARKS:
            eager(name, 1)
    lib.capturing = True                         # a graph of two cycles
    before = profiling.captured_marks()
    for c in range(2):
        profiling.set_cycle(c)
        for name in profiling.MARKS:
            profiling.mark(name, card)
    held = profiling.captured_marks() - before
    lib.capturing = False
    assert held == 8 and lib.count == 5
    for d in (2, 3, 4):
        with profiling.span("trainer.dispatch", dispatch=True):
            t = time.perf_counter_ns()
            lib.replay()
            profiling.replayed(held)
            launched += [(d, name, t) for c in range(2)
                         for name in profiling.MARKS]
    rec = profiling.record()
    assert lib.count == 29 and rec.dropped_marks == 29 - 16
    kept = launched[-16:]
    assert [m.seq for m in rec.marks] == list(range(13, 29))
    assert [(m.dispatch, m.name) for m in rec.marks] == [
        (d, n) for d, n, _ in kept]
    cal = rec.calibration
    assert cal["interval_ns"] > 0
    # the stand-in's timer gains 1e-5 of the host clock's time
    assert cal["drift_ns"] == pytest.approx(-1e-5 * cal["interval_ns"],
                                            abs=2 * cal["error_ns"] + 1000)
    for m, (_, _, t) in zip(rec.marks, kept):
        assert abs(m.t_ns - t) < 2 * cal["error_ns"] + 200_000
    spans = {s.dispatch: s for s in rec.spans}
    for m in rec.marks:
        assert spans[m.dispatch].start_ns <= m.t_ns <= spans[m.dispatch].end_ns


def test_collect_time_sums_the_epochs_dispatch_spans():
    tr = _onpolicy()
    tr.step_per_epoch = 3 * 8 * 8
    t0 = time.perf_counter_ns()
    next(tr)
    end = time.perf_counter_ns()
    spans = profiling.spans_since(t0, "trainer.dispatch")
    assert len(spans) == 3
    busy = 1e-9 * sum(s.end_ns - s.start_ns for s in spans)
    assert busy <= tr.collect_time <= busy + 1e-9 * (end - spans[-1].end_ns)
    profiling.enable(False)             # no spans: the loop's own time
    before = tr.collect_time
    next(tr)
    assert tr.collect_time > before
