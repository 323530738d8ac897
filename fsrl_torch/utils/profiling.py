"""Profiling hooks (port of ``fsrl_tpu/utils/profiling.py``): the
reference tracks only wall-clock counters, which live in the trainers;
this module adds a ``torch.profiler`` trace, viewable in TensorBoard's
profiler plugin or in a Chrome trace viewer, and a section timer."""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None,
          name: str = "train") -> Iterator[None]:
    """Capture a ``torch.profiler`` trace (host activity, and the card's
    where there is one) around a code block, written under ``log_dir`` as
    ``<name>.<timestamp>.pt.trace.json`` when the block ends; a no-op for
    ``log_dir=None``:

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
