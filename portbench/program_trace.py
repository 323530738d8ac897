"""The program's own trace (``fsrl_torch.utils.profiling``) as the
per-layer readers of it take it: the record, and the numbers of the
traced run's window dispatches (the last ``window.dispatches +
traffic.profile_dispatches`` dispatches, less the profiled slice's)."""

from __future__ import annotations


def window(rec: dict):
    """``(record, dispatch numbers)``, or None where the program records
    no trace or fewer dispatches than the window and slice ran."""
    from fsrl_torch.utils import profiling

    read = getattr(profiling, "record", None)
    if read is None:
        return None
    trace = read()
    n = rec["window"]["dispatches"]
    p = rec["traffic"]["profile_dispatches"]
    nums = trace.dispatches()
    if n <= 0 or len(nums) < n + p:
        return None
    return trace, nums[len(nums) - n - p:len(nums) - p]


def mean_ms(values_ns: list) -> float | None:
    return 1e-6 * sum(values_ns) / len(values_ns) if values_ns else None


def cycle_ms(rec: dict, first: str, last: str) -> float | None:
    """The mean device time, over the window's cycles, from each cycle's
    mark ``first`` to its mark ``last``."""
    found = window(rec)
    if found is None:
        return None
    trace, nums = found
    return mean_ms([c[last] - c[first] for c in trace.cycles(nums)
                    if first in c and last in c])


def span_ms_per_dispatch(rec: dict, name: str) -> float | None:
    """The host time in spans named ``name``, summed in each window
    dispatch that has one, the mean over those dispatches."""
    found = window(rec)
    if found is None:
        return None
    trace, nums = found
    want, per = set(nums), {}
    for s in trace.spans:
        if s.name == name and s.dispatch in want:
            per[s.dispatch] = per.get(s.dispatch, 0) + s.end_ns - s.start_ns
    return mean_ms(list(per.values()))
