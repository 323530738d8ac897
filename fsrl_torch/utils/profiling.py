"""Profiling hooks (port of ``fsrl_tpu/utils/profiling.py``) and the
port's own trace.

The reference tracks only wall-clock counters, which live in the
trainers. This module adds a ``torch.profiler`` trace (:func:`trace`,
viewable in TensorBoard's profiler plugin or in a Chrome trace viewer), a
section timer (:class:`Stopwatch`), and an in-memory trace fed from inside
the port, on by default (:func:`enable`):

* **Host spans** (:func:`span`): name, start and end on one host clock
  (``time.perf_counter_ns``), the enclosing span, the number of the
  dispatch the span belongs to, and a label. The port records
  ``trainer.dispatch`` (all of ``BaseTrainer._run_iter``; each one begins
  a new dispatch number), ``graphs.replay`` (``graph.replay()``, the
  host's ``cudaGraphLaunch``, labelled with the graph's name),
  ``trainer.log_readback`` (the train log's stack and ``.tolist()``) and
  ``collector.collect`` (``OffpolicyTrainer.collect()``, eager). Nothing
  is recorded while a CUDA graph is being captured: a graph body's Python
  runs only then. While a ``torch.profiler`` is active each span is also a
  range of the same name on the profiler's host timeline, beside the
  device's operations (as in :func:`trace`'s files): an operator's range
  (``cpu_op``), not a user annotation, which the profiler would copy onto
  the device's timeline as if it were device work.
* **Device marks** (:func:`mark`): on the card a one-thread kernel
  (``csrc/marks.cu``) that appends its mark, the cycle index and the
  card's ``%globaltimer`` to a ring in the kernel library's own device
  memory. A mark in the eager code is recorded into a graph captured from
  it, and each replay appends its marks with no host sync. The trainers
  mark four boundaries of a cycle: ``cycle.start``, ``rollout.end``,
  ``process.end`` (the update's preparation done: on-policy the end of
  ``process_rollout``, off-policy the end of ``collect()``) and
  ``cycle.end``. On the CPU a mark records the host clock at once.

Both rings are bounded (:data:`CAPACITY` entries; the oldest are dropped)
and written nowhere. :func:`record` reads them: the spans, and the marks
on the host clock with their dispatch numbers. The card's timer is mapped
onto the host clock by a calibration made at the first mark (a clock
kernel, a synchronize, the host clock on both sides) and made again at
each read; marks between the two are mapped by the line through them, and
``Record.calibration`` reports the drift. Reading drains the card.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import time
from typing import Iterator, Optional

import numpy as np
import torch

from fsrl_torch.device import capturing
from fsrl_torch.ops import kernels

# entries each ring keeps
CAPACITY = 1 << 16
MARKS = ("cycle.start", "rollout.end", "process.end", "cycle.end")
_MARK_ID = {name: i for i, name in enumerate(MARKS)}
# the card's ring entry (csrc/marks.cu)
_ENTRY = np.dtype([("seq", "<u8"), ("time", "<u8"), ("id", "<u4"),
                   ("cycle", "<u4")])


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None,
          name: str = "train") -> Iterator[None]:
    """Capture a ``torch.profiler`` trace (host activity, and the card's
    where there is one) around a code block, written under ``log_dir`` as
    ``<name>.<timestamp>.pt.trace.json`` when the block ends; a no-op for
    ``log_dir=None``. The port's host spans appear in it as ranges of
    their names:

        with trace("logs/profile"):
            for _ in range(10):
                trainer._run_iter()
    """
    if log_dir is None:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(
                     log_dir, worker_name=name)):
        yield


class Stopwatch:
    """Cheap section timer mirroring the reference's collect/update split
    (``base_trainer.py:317-356``) and CVPO's E-step / M-step timers."""

    def __init__(self):
        self.totals: dict[str, float] = {}

    @contextlib.contextmanager
    def section(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + \
                time.perf_counter() - t0


# ---------------------------------------------------------------- the trace
@dataclasses.dataclass(frozen=True)
class Span:
    """A host span; times in ns of ``time.perf_counter_ns``."""
    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    dispatch: Optional[int]
    label: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class Mark:
    """A device mark, its time on the host clock (ns of
    ``time.perf_counter_ns``)."""
    seq: int
    name: str
    cycle: int
    dispatch: Optional[int]
    t_ns: int


@dataclasses.dataclass
class Record:
    """What :func:`record` read: spans in the order they ended, marks in
    the order they ran, and the card's calibration (None without marks
    on the card): ``offset_ns`` (host minus card clock at the first
    calibration), ``drift_ns`` (the offset's change by the last one),
    ``interval_ns`` (between the two), ``error_ns`` (half the widest
    host interval around a clock read)."""
    spans: list[Span]
    marks: list[Mark]
    calibration: Optional[dict]
    dropped_marks: int = 0

    def dispatches(self) -> list[int]:
        """The numbers of the dispatches whose ``trainer.dispatch`` span
        the ring holds."""
        return sorted(s.dispatch for s in self.spans
                      if s.name == "trainer.dispatch")

    def cycles(self, dispatches) -> list[dict[str, int]]:
        """For each cycle of the given dispatches, in order, each mark's
        time by name."""
        want = set(dispatches)
        out: dict = {}
        for m in self.marks:
            if m.dispatch in want:
                out.setdefault((m.dispatch, m.cycle), {})[m.name] = m.t_ns
        return [out[k] for k in sorted(out)]


class _State:
    """The trace's record. One a process, as the card's ring is: the kernel
    library's static memory, one a process and card."""

    def __init__(self):
        self.on = True
        self.spans: collections.deque = collections.deque(maxlen=CAPACITY)
        self.stack: list[int] = []
        self.next_span = 0
        self.dispatch: Optional[int] = None     # the open dispatch
        self.dispatches = 0                     # dispatches begun
        self.cycle = 0
        self.host_marks: collections.deque = collections.deque(
            maxlen=CAPACITY)
        self.host_seq = 0
        # marks on the card: launched eagerly or replayed (so run, once
        # the card drains), and recorded into graphs
        self.seq = 0
        self.captured = 0
        # (first mark, dispatch number, end mark) of each dispatch
        self.ranges: collections.deque = collections.deque(maxlen=CAPACITY)
        self.calibration: Optional[tuple[int, int, int]] = None


_S = _State()


def enable(on: bool = True) -> None:
    """Switch the trace on or off (it starts on). Read at each span and
    mark: a graph captured while it is off holds no marks, and one
    captured while it is on appends its marks at every replay."""
    _S.on = bool(on)


def reset() -> None:
    """Forget the host's record (spans, CPU marks, dispatch numbers); the
    card's ring keeps counting."""
    on, seq, captured, calibration = (_S.on, _S.seq, _S.captured,
                                      _S.calibration)
    _S.__init__()
    _S.on, _S.seq, _S.captured = on, seq, captured
    _S.calibration = calibration


@contextlib.contextmanager
def span(name: str, label: Optional[str] = None,
         dispatch: bool = False) -> Iterator[None]:
    """Record a host span around a block (not while capturing a graph or
    while the trace is off); ``dispatch`` starts a new dispatch number,
    which the spans and marks inside it take."""
    if not _S.on or capturing():
        yield
        return
    sid = _S.next_span
    _S.next_span += 1
    parent = _S.stack[-1] if _S.stack else None
    outer = _S.dispatch
    if dispatch:
        _S.dispatches += 1
        _S.dispatch = _S.dispatches
        first = _S.seq
    ranged = None
    if torch.autograd._profiler_enabled():
        # torch.profiler.record_function's user annotation would also span
        # the device work launched inside it on the device's timeline
        ranged = torch._C._profiler._RecordFunctionFast(name)
        ranged.__enter__()
    _S.stack.append(sid)
    t0 = time.perf_counter_ns()
    try:
        yield
    finally:
        t1 = time.perf_counter_ns()
        _S.stack.pop()
        if ranged is not None:
            ranged.__exit__(None, None, None)
        _S.spans.append(Span(sid, name, t0, t1, parent, _S.dispatch, label))
        if dispatch:
            _S.ranges.append((first, _S.dispatch, _S.seq))
            _S.dispatch = outer


def spans_since(t0_ns: int, name: str) -> list[Span]:
    """The recorded spans named ``name`` that began at or after ``t0_ns``,
    in the order they ended."""
    return [s for s in _S.spans if s.start_ns >= t0_ns and s.name == name]


def set_cycle(index: int) -> None:
    """The index, within its dispatch, of the cycle the next marks
    belong to."""
    _S.cycle = int(index)


def mark(name: str, device: torch.device) -> None:
    """Mark ``name`` (one of :data:`MARKS`) on ``device``'s current
    stream (see the module's docstring); nothing while the trace is
    off."""
    if not _S.on:
        return
    if device.type != "cuda":
        _S.host_marks.append(Mark(_S.host_seq, name, _S.cycle, _S.dispatch,
                                  time.perf_counter_ns()))
        _S.host_seq += 1
        return
    lib = kernels.library()
    graphed = capturing()
    if _S.calibration is None and not graphed:
        _S.calibration = _calibrate(lib)
    kernels.check(lib.fsrl_mark(_MARK_ID[name], _S.cycle,
                                kernels.stream_ptr()), "mark")
    if graphed:
        _S.captured += 1
    else:
        _S.seq += 1


def captured_marks() -> int:
    """Marks recorded into graphs so far: a graph's own are the change
    over its capture."""
    return _S.captured


def replayed(marks: int) -> None:
    """A graph holding ``marks`` marks was replayed."""
    _S.seq += marks


def _calibrate(lib, tries: int = 5) -> tuple[int, int, int]:
    """``(host ns, card ns, error ns)``: the card's timer read by a clock
    kernel on a drained card, against the midpoint of the host clock
    before its launch and after the synchronize; the tightest of
    ``tries``."""
    stream = torch.cuda.current_stream()
    torch.cuda.synchronize()
    best = None
    for _ in range(tries):
        t0 = time.perf_counter_ns()
        kernels.check(lib.fsrl_marks_clock(stream.cuda_stream), "clock")
        stream.synchronize()
        t1 = time.perf_counter_ns()
        word = np.zeros(1, np.uint64)
        kernels.check(lib.fsrl_marks_clock_read(word.ctypes.data),
                      "clock read")
        if best is None or t1 - t0 < 2 * best[2]:
            best = ((t0 + t1) // 2, int(word[0]), (t1 - t0) // 2)
    return best


def _card_marks(cal0: tuple, cal1: tuple) -> tuple[list[Mark], int]:
    """The card's ring, on the host clock by the line through the two
    calibrations; and how many marks it no longer holds."""
    lib = kernels.library()
    ring = np.zeros(lib.fsrl_marks_capacity(), _ENTRY)
    count = np.zeros(1, np.uint64)
    kernels.check(lib.fsrl_marks_read(ring.ctypes.data, count.ctypes.data),
                  "marks read")
    n = int(count[0])
    ring = np.sort(ring[:n], order="seq")
    (h0, g0, _), (h1, g1, _) = cal0, cal1
    slope = (h1 - h0 - (g1 - g0)) / (g1 - g0) if g1 > g0 else 0.0
    starts = [r[0] for r in _S.ranges]
    marks = []
    for seq, t, mid, cyc in ring.tolist():
        i = bisect.bisect_right(starts, seq) - 1
        d = (_S.ranges[i][1] if i >= 0 and seq < _S.ranges[i][2]
             else None)
        host = h0 + (t - g0) + round(slope * (t - g0))
        marks.append(Mark(seq, MARKS[mid], cyc, d, host))
    return marks, max(0, n - len(ring))


def record() -> Record:
    """The trace so far (see the module's docstring)."""
    marks, dropped, calibration = list(_S.host_marks), 0, None
    if _S.calibration is not None:
        cal0 = _S.calibration
        cal1 = _calibrate(kernels.library())
        card, dropped = _card_marks(cal0, cal1)
        marks = sorted(marks + card, key=lambda m: m.t_ns)
        calibration = dict(
            offset_ns=cal0[0] - cal0[1],
            drift_ns=(cal1[0] - cal1[1]) - (cal0[0] - cal0[1]),
            interval_ns=cal1[0] - cal0[0], error_ns=max(cal0[2], cal1[2]))
    return Record(list(_S.spans), marks, calibration, dropped)
