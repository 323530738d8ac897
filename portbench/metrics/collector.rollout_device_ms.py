"""``collector.rollout_device_ms``: the mean device time of a cycle's
rollout in the traced run's window, from its ``cycle.start`` mark to its
``rollout.end`` mark (the program's device marks,
``fsrl_torch.utils.profiling``)."""

from portbench.program_trace import cycle_ms


def read(rec: dict):
    return cycle_ms(rec, "cycle.start", "rollout.end")
