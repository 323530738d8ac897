"""A steady slice of dispatches under ``torch.profiler``, read from the
profiler's raw events: the device's busy time (the union of every
device operation's interval), each kernel's launches and times, and the
longest idle gaps by the host operation running in them."""

from __future__ import annotations

import collections
import re

import torch

MARK = "portbench.slice"
TOP = 10


def _name(s: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.:-]", "_", s)[:64]


def _merge(intervals: list[tuple[int, int]]) -> list[list[int]]:
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def profile_slice(dispatch, n: int) -> dict:
    """``n`` dispatches, profiled. Returns ``busy_s``, ``window_s``,
    ``kernels`` (name -> list of device seconds a launch) and
    ``breakdown``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(MARK):
            for _ in range(n):
                dispatch()
            torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    dev, host, mark = [], [], None
    for e in events:
        span = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
        if e.name() == MARK:
            # the slice's own mark, on the host (and its copy on the
            # device's timeline, which is no operation)
            if e.device_type() != DeviceType.CUDA:
                mark = span
        elif e.device_type() == DeviceType.CUDA:
            dev.append(span)
        else:
            host.append(span)
    if mark is None or not dev:
        raise RuntimeError("the profiler saw no device operation in the "
                           "slice")
    lo, hi = mark[0], mark[1]
    busy = _merge([(max(a, lo), min(b, hi)) for a, b, _ in dev
                   if b > lo and a < hi])
    busy_ns = sum(b - a for a, b in busy)
    kernels: dict[str, list[float]] = collections.defaultdict(list)
    for a, b, name in dev:
        kernels[name].append((b - a) * 1e-9)
    totals = sorted(((_name(k), sum(v)) for k, v in kernels.items()),
                    key=lambda kv: -kv[1])[:TOP]
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    idle = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]:
        mid = (a + b) // 2
        cover = [h for h in host if h[0] <= mid < h[1]]
        name = (min(cover, key=lambda h: h[1] - h[0])[2] if cover
                else "no_host_operation")
        idle.append([_name(name), (b - a) * 1e-9])
    return dict(busy_s=busy_ns * 1e-9, window_s=(hi - lo) * 1e-9,
                kernels=dict(kernels),
                breakdown=dict(device_ops=[list(t) for t in totals],
                               idle_gaps=idle))
