"""One run of one cell: build the program, drive its first dispatches
(set-up, and the readings the comparison takes), measure a window of
dispatches, optionally trace a steady slice, then free the program, run
the reference and decide ``correct``."""

from __future__ import annotations

import functools
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from portbench import compare
from portbench.drivers.common import CHECKED_STEPS

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "fsrl_tpu")
GIB = 2 ** 30


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(bench: dict, name: str) -> dict:
    """The cell's entry and the files found by its names."""
    (cell,) = [w for w in bench["workloads"] if w["name"] == name]
    (conf,) = [c for c in bench["configs"] if c["name"] == cell["config"]]
    return dict(cell=cell, config=load_json(REPO / conf["file"]),
                traffic=load_json(HERE / "traffic"
                                  / f"{cell['traffic']}.json"),
                limits=load_json(HERE / "limits" / f"{name}.json"))


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}",
        HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def per_layer(bench: dict, cell: str, records: dict,
              required: bool = False) -> dict:
    """Every per-layer metric that lists this cell (or lists none), by its
    reader. A reader that finds nothing returns None: the metric is left
    out, or where ``required`` (a traced run on the card, which has every
    record) the run fails, so that a metric cannot fall silent."""
    out = {}
    for m in bench["per_layer"]:
        if "workloads" in m and cell not in m["workloads"]:
            continue
        value = load_reader(m["name"])(records)
        if value is not None:
            out[m["name"]] = dict(value=value, unit=m["unit"])
        elif required:
            raise RuntimeError(f"the reader of {m['name']} found nothing "
                               f"to read in {cell}'s traced run")
    return out


def graph_counts() -> tuple[int, int]:
    from fsrl_torch.trainer import graphs
    return sum(graphs.CAPTURES.values()), sum(graphs.REPLAYS.values())


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def add_spans(trainer, names: list[str], spans: dict, device) -> None:
    """Wrap each named trainer method in a host-clock span that starts and
    ends on a drained device."""
    for name in names:
        fn = getattr(trainer, name)

        @functools.wraps(fn)
        def timed(*a, _fn=fn, _name=name, **k):
            sync(device)
            t0 = time.perf_counter()
            out = _fn(*a, **k)
            sync(device)
            spans.setdefault(_name, []).append(time.perf_counter() - t0)
            return out
        setattr(trainer, name, timed)


def window(prog, seconds: float, device) -> tuple[int, float]:
    """Dispatches until ``seconds`` have passed; the count and the time
    from the first dispatch to the drained device after the last."""
    sync(device)
    t0 = time.perf_counter()
    n = 0
    while True:
        prog.dispatch()
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    return n, time.perf_counter() - t0


def run_cell(bench: dict, name: str, seed: int, seconds: float,
             trace: bool, t_start: float, device="cuda",
             traffic: dict | None = None, fault: str | None = None) -> dict:
    """The result line's fields, and ``checked`` (each compared number
    with its limit). ``traffic`` replaces the cell's (the CPU tests' tiny
    sizes); ``fault`` plants a fault in the program. Off the card what
    only the card has (graphs, peak memory, the trace) is skipped."""
    on_card = torch.device(device).type == "cuda"
    files = cell_files(bench, name)
    cfg, limits = files["config"], files["limits"]["limits"]
    traffic = traffic or files["traffic"]
    driver = importlib.import_module(f"portbench.drivers.{cfg['driver']}")
    reference = importlib.import_module(
        f"portbench.reference.{cfg['algorithm']}")

    prog = driver.Program(cfg, traffic, seed, device, fault)
    prog.check_dispatches()
    sync(device)
    if on_card and prog.mode != traffic["dispatch_mode"]:
        raise RuntimeError(f"dispatch mode {prog.mode!r}, the cell states "
                           f"{traffic['dispatch_mode']!r}")
    setup_s = time.perf_counter() - t_start

    caps0, reps0 = graph_counts()
    setup_peak = torch.cuda.max_memory_reserved() if on_card else 0
    if on_card:
        # what the set-up's eager dispatch left in the allocator's cache
        # goes back; the graphs' pools stay, as they are in use
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    spans: dict = {}
    if trace:
        add_spans(prog.trainer, traffic.get("spans", []), spans, device)
    n, secs = window(prog, seconds, device)
    window_peak = torch.cuda.max_memory_reserved() if on_card else 0
    prof = None
    if trace and on_card:
        from portbench.trace import profile_slice
        prof = profile_slice(prog.dispatch, traffic["profile_dispatches"])
    caps1, reps1 = graph_counts()
    if on_card and (caps1 != caps0 or reps1 - reps0 < n):
        raise RuntimeError(f"the window captured {caps1 - caps0} graphs "
                           f"and replayed {reps1 - reps0} in {n} "
                           "dispatches: not the cell's steady state")
    peak = max(setup_peak, window_peak, torch.cuda.max_memory_reserved()
               if on_card else 0)

    readings, weights = prog.readings, prog.weights
    prog.free()
    ref = reference.run(cfg, traffic, weights, seed, device,
                        checked=CHECKED_STEPS)
    values = compare.gaps(readings, ref)
    checked = {k: dict(value=values[k], limit=limits[k]) for k in limits}
    correct = compare.judge(values, limits)

    if trace:
        records = dict(cell=files["cell"], config=cfg, traffic=traffic,
                       window=dict(dispatches=n, seconds=secs),
                       spans=spans,
                       peaks=load_json(HERE / "peaks.json"),
                       profile=prof)
        metrics = per_layer(bench, name, records, required=on_card)
    else:
        values = dict(env_steps_per_s=n * prog.steps_per_dispatch / secs,
                      peak_mem_gib=window_peak / GIB, setup_s=setup_s)
        metrics = {m["name"]: dict(value=values[m["name"]], unit=m["unit"])
                   for m in bench["end_to_end"]}
    out = dict(correct=correct, attempted=n, failed=0, metrics=metrics,
               device=dict(platform="gpu",
                           kind=(torch.cuda.get_device_name(0) if on_card
                                 else "cpu"),
                           count=1, memory_peak_bytes=int(peak)))
    if prof is not None:
        out["device"].update(busy_s=prof["busy_s"],
                             window_s=prof["window_s"])
        out["breakdown"] = prof["breakdown"]
    out["checked"] = checked
    return out

