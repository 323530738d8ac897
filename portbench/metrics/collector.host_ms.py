"""``collector.host_ms``: the mean host time of the off-policy trainer's
eager ``collect()`` in the traced run's window, its ``collector.collect``
span (the program's host spans, ``fsrl_torch.utils.profiling``), with no
synchronize of its own."""

from portbench.program_trace import span_ms_per_dispatch


def read(rec: dict):
    return span_ms_per_dispatch(rec, "collector.collect")
