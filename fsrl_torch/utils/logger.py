"""Metric logging (port of ``fsrl_tpu/utils/logger.py``): a running-average
registry with tab-prefixed keys (``train/``, ``test/``, ``loss/``,
``update/``), an epoch-end ``write`` (tabular print, a ``progress.txt`` TSV
and the subclass's stream, then reset) and the streaming
``write_without_reset``, checkpoint hooks, a yaml snapshot of the config
next to the checkpoints, the step counters for resume, the no-op
:class:`DummyLogger`, and the Tensorboard and wandb sinks."""

from __future__ import annotations

import atexit
import dataclasses
import os
import os.path as osp
import math
from typing import Any, Callable, Iterable, Optional


class RunningAverage:
    """Mergeable Welford running mean and variance."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.n, self.mean, self.M2 = 0, 0.0, 0.0

    def add(self, x: float):
        self.n += 1
        d = x - self.mean
        self.mean += d / self.n
        self.M2 += d * (x - self.mean)

    @property
    def std(self) -> float:
        """Population standard deviation; 0 below two samples."""
        return math.sqrt(self.M2 / self.n) if self.n > 1 else 0.0

    def __add__(self, other: "RunningAverage") -> "RunningAverage":
        """The merge of two averages (Chan's parallel update)."""
        out = RunningAverage()
        n = self.n + other.n
        if n:
            delta = other.mean - self.mean
            out.n = n
            out.mean = self.mean + delta * other.n / n
            out.M2 = self.M2 + other.M2 + delta ** 2 * self.n * other.n / n
        return out


def colorize(string: str, color: str = "green", bold: bool = False) -> str:
    """``string`` in ANSI colour (gray, red, green, yellow, blue, magenta,
    cyan, white; green for any other name)."""
    colors = dict(gray=30, red=31, green=32, yellow=33, blue=34, magenta=35,
                  cyan=36, white=37)
    attr = [str(colors.get(color, 32))] + (["1"] if bold else [])
    return f"\x1b[{';'.join(attr)}m{string}\x1b[0m"


class BaseLogger:
    """Registry plus text sinks."""

    def __init__(self, log_dir: Optional[str] = None, log_txt: bool = True,
                 name: Optional[str] = None):
        self.name = name
        self.log_dir = osp.join(log_dir, name) if log_dir and name else log_dir
        if self.log_dir:
            os.makedirs(osp.join(self.log_dir, "checkpoint"), exist_ok=True)
        self.output_file = None
        if log_txt and self.log_dir:
            self.output_file = open(osp.join(self.log_dir, "progress.txt"),
                                    "w")
            atexit.register(self.output_file.close)
        self.first_row = True
        self.stats: dict[str, RunningAverage] = {}
        self.checkpoint_fn: Optional[Callable[[Optional[str]], Any]] = None

    def store(self, tab: Optional[str] = None, **kwargs) -> None:
        for k, v in kwargs.items():
            key = f"{tab}/{k}" if tab else k
            self.stats.setdefault(key, RunningAverage()).add(float(v))

    def get_mean(self, key: str) -> float:
        """The running mean under ``key`` (tab included); 0 if nothing was
        stored."""
        ra = self.stats.get(key)
        return ra.mean if ra and ra.n else 0.0

    def stats_mean(self) -> dict[str, float]:
        return {k: v.mean for k, v in self.stats.items() if v.n}

    def reset(self) -> None:
        for v in self.stats.values():
            v.reset()

    def write(self, step: int, display: bool = True,
              display_keys: Optional[Iterable[str]] = None) -> None:
        row = dict(self.stats_mean())
        row["update/env_step"] = step
        self._stream(row, step)
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

    def write_without_reset(self, step: int) -> None:
        """Stream the running means at ``step`` and keep them."""
        self._stream(self.stats_mean(), step)

    def _stream(self, row: dict[str, float], step: int) -> None:
        """Hook of the Tensorboard and wandb subclasses."""

    def print(self, msg: str, color: str = "green") -> None:
        """``msg`` in bold colour."""
        print(colorize(msg, color, bold=True))

    def setup_checkpoint_fn(self,
                            fn: Callable[[Optional[str]], Any]) -> None:
        """Register ``fn(suffix)``, which ``save_checkpoint`` calls."""
        self.checkpoint_fn = fn

    def save_checkpoint(self, suffix: Optional[str] = None) -> None:
        if self.checkpoint_fn:
            self.checkpoint_fn(suffix)

    def save_config(self, config: Any, verbose: bool = False) -> None:
        """Write ``config`` (a dict or a config dataclass) as
        ``config.yaml`` into the run directory."""
        if self.log_dir:
            import yaml
            with open(osp.join(self.log_dir, "config.yaml"), "w") as f:
                yaml.safe_dump(_plain(config), f, default_flow_style=False)
        if verbose:
            self.print(f"config: {config}")

    def restore_data(self) -> tuple[int, int, int]:
        """``(epoch, env_step, gradient_step)`` for resume; zeros where the
        logger keeps nothing to restore from."""
        return 0, 0, 0

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

    def write_without_reset(self, step):
        pass

    def display_tabular(self, row, display_keys=None):
        pass

    def print(self, msg, color="green"):
        pass


class TensorboardLogger(BaseLogger):
    """tensorboardX sink, and the step counters recovered from its event
    files."""

    def __init__(self, log_dir: str, log_txt: bool = True,
                 name: Optional[str] = None):
        super().__init__(log_dir, log_txt, name)
        from tensorboardX import SummaryWriter
        self.writer = SummaryWriter(self.log_dir)
        # the writer queues events for a thread of its own: closing drains
        # the queue, flushing alone does not
        atexit.register(self.writer.close)

    def _stream(self, row: dict[str, float], step: int) -> None:
        for k, v in row.items():
            self.writer.add_scalar(k, v, global_step=step)
        self.writer.flush()

    def restore_data(self) -> tuple[int, int, int]:
        """The last ``update/epoch``, ``update/env_step`` and
        ``update/gradient_step`` the trainer logged; zeros without the
        ``tensorboard`` package or without events."""
        try:
            from tensorboard.backend.event_processing import event_accumulator
        except ImportError:
            return 0, 0, 0
        self.writer.close()      # drain the queue; reopens on the next write
        ea = event_accumulator.EventAccumulator(self.log_dir)
        ea.Reload()

        def last_value(tag: str) -> int:
            try:
                return int(ea.Scalars(tag)[-1].value)
            except (KeyError, IndexError):
                return 0

        return (last_value("update/epoch"), last_value("update/env_step"),
                last_value("update/gradient_step"))


class WandbLogger(BaseLogger):
    """wandb sink; text only where the ``wandb`` package is missing."""

    def __init__(self, log_dir: str, log_txt: bool = True,
                 name: Optional[str] = None, project: str = "fsrl-torch",
                 group: Optional[str] = None):
        super().__init__(log_dir, log_txt, name)
        try:
            import wandb
        except ImportError:
            self.wandb_run = None
        else:
            self.wandb_run = wandb.run or wandb.init(
                project=project, group=group, name=name, dir=log_dir,
                resume="allow")

    def _stream(self, row: dict[str, float], step: int) -> None:
        if self.wandb_run is not None:
            self.wandb_run.log(row, step=step)

    def save_config(self, config: Any, verbose: bool = False) -> None:
        super().save_config(config, verbose)
        if self.wandb_run is not None:
            self.wandb_run.config.update(_plain(config),
                                         allow_val_change=True)


def _plain(obj: Any) -> Any:
    """Dataclasses, tuples and tensor or numpy scalars as plain yaml
    types, recursively."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if hasattr(obj, "item") and not isinstance(obj, (str, bytes)):
        return obj.item()
    return obj
