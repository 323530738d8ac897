"""The port's profiling hooks (``fsrl_torch/utils/profiling.py``) against
the JAX package's: the section timer keeps the same totals, and the trace
context is a no-op without a directory and writes a ``torch.profiler``
trace with one."""

import json
import time

import pytest
import torch

from fsrl_torch.utils.profiling import Stopwatch, trace
from fsrl_tpu.utils.profiling import Stopwatch as JStopwatch


def _drive(sw, clock):
    """Three sections, one of them twice and one that raises, on a fake
    clock: the totals depend on nothing but the clock's readings."""
    with sw.section("collect"):
        clock.append(0.25)
    with sw.section("update"):
        clock.append(1.5)
    with pytest.raises(RuntimeError):
        with sw.section("collect"):
            clock.append(0.5)
            raise RuntimeError("a section that fails still counts")


def test_stopwatch_totals_match_jax(monkeypatch):
    totals = []
    for cls in (JStopwatch, Stopwatch):
        now = [0.0]
        steps = []

        def perf_counter():
            # each call advances by the next queued step, if any
            if steps:
                now[0] += steps.pop(0)
            return now[0]

        monkeypatch.setattr(time, "perf_counter", perf_counter)
        sw = cls()
        _drive(sw, steps)
        totals.append(sw.totals)
    assert totals[0] == totals[1] == {"collect": 0.75, "update": 1.5}


def test_trace_without_a_directory_is_a_no_op(tmp_path):
    with trace(None):
        x = torch.ones(3).sum()
    assert float(x) == 3.0
    assert not any(tmp_path.iterdir())


def test_trace_writes_a_profile_on_the_cpu(tmp_path):
    with trace(str(tmp_path), name="unit"):
        torch.randn(64, 64) @ torch.randn(64, 64)
    files = list(tmp_path.glob("unit*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
