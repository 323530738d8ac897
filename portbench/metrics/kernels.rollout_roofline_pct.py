"""``kernels.rollout_roofline_pct``: the rollout kernel's least time for
the cell's segment (``portbench/flops/rollout.py``) over its mean device
time a launch in the traced slice. Its launches are the kernels of the
configuration's width: ``rollout_kernel<...>`` at hidden 128,
``rollout_kernel_h256<...>`` at 256. Where the slice holds none, the
program's rollout at this width is the collector's loop (a program before
the kernel took the width): the rollout's mean device time a cycle, from
the program's marks ``cycle.start`` to ``rollout.end``, stands in."""

from portbench.flops import rollout
from portbench.program_trace import cycle_ms


def kernel(cfg: dict) -> str:
    """The part of the profiler's name that marks the width's launches."""
    h1 = cfg["algorithm_kwargs"]["hidden_sizes"][0]
    return "::rollout_kernel<" if h1 == 128 else f"::rollout_kernel_h{h1}<"


def read(rec: dict):
    prof, cfg = rec.get("profile"), rec["config"]
    if not prof:
        return None
    times = [t for name, ts in prof["kernels"].items()
             if kernel(cfg) in name for t in ts]
    if times:
        seconds = sum(times) / len(times)
    else:
        ms = cycle_ms(rec, "cycle.start", "rollout.end")
        if ms is None:
            return None
        seconds = 1e-3 * ms
    return 100.0 * rollout.bound_s(cfg, rec["traffic"], rec["peaks"]) / seconds
