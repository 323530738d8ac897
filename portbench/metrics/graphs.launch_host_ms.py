"""``graphs.launch_host_ms``: the host time a window dispatch spends
launching its CUDA graphs, the ``graphs.replay`` spans summed per
dispatch (the program's host spans, ``fsrl_torch.utils.profiling``)."""

from portbench.program_trace import span_ms_per_dispatch


def read(rec: dict):
    return span_ms_per_dispatch(rec, "graphs.replay")
