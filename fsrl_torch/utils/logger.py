"""Metric logging (the part of ``fsrl_tpu/utils/logger.py`` the trainer
calls): a running-average registry with tab-prefixed keys (``train/``,
``test/``, ``loss/``, ``update/``), an epoch-end ``write`` (tabular print and
a ``progress.txt`` TSV, then reset) and the no-op :class:`DummyLogger`."""

from __future__ import annotations

import atexit
import os
import os.path as osp
from typing import Iterable, Optional


class RunningAverage:
    """Running mean."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.n, self.mean = 0, 0.0

    def add(self, x: float):
        self.n += 1
        self.mean += (x - self.mean) / self.n


class BaseLogger:
    """Registry plus text sinks."""

    def __init__(self, log_dir: Optional[str] = None, log_txt: bool = True,
                 name: Optional[str] = None):
        self.name = name
        self.log_dir = osp.join(log_dir, name) if log_dir and name else log_dir
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
        self.output_file = None
        if log_txt and self.log_dir:
            self.output_file = open(osp.join(self.log_dir, "progress.txt"),
                                    "w")
            atexit.register(self.output_file.close)
        self.first_row = True
        self.stats: dict[str, RunningAverage] = {}

    def store(self, tab: Optional[str] = None, **kwargs) -> None:
        for k, v in kwargs.items():
            key = f"{tab}/{k}" if tab else k
            self.stats.setdefault(key, RunningAverage()).add(float(v))

    def stats_mean(self) -> dict[str, float]:
        return {k: v.mean for k, v in self.stats.items() if v.n}

    def reset(self) -> None:
        for v in self.stats.values():
            v.reset()

    def write(self, step: int, display: bool = True,
              display_keys: Optional[Iterable[str]] = None) -> None:
        row = dict(self.stats_mean())
        row["update/env_step"] = step
        if self.output_file is not None:
            keys = sorted(row)
            if self.first_row:
                self.output_file.write("\t".join(keys) + "\n")
                self.first_row = False
            self.output_file.write(
                "\t".join(str(row.get(k, "")) for k in keys) + "\n")
            self.output_file.flush()
        if display:
            self.display_tabular(row, display_keys)
        self.reset()

    def display_tabular(self, row: dict[str, float],
                        display_keys: Optional[Iterable[str]] = None) -> None:
        keys = sorted(display_keys or row)
        width = max((len(k) for k in keys), default=8)
        line = "-" * (width + 20)
        print(line)
        for k in keys:
            v = row.get(k, 0.0)
            vs = f"{v:8.4g}" if isinstance(v, float) else str(v)
            print(f"| {k:<{width}} | {vs:>14} |")
        print(line, flush=True)


class DummyLogger(BaseLogger):
    """No-op logger."""

    def __init__(self):
        super().__init__(log_dir=None, log_txt=False)

    def store(self, tab=None, **kwargs):
        pass

    def write(self, step, display=True, display_keys=None):
        pass
