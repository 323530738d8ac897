"""``update.device_ms``: the mean device time of a cycle's update in the
traced run's window, its preparation and its grad steps: from the
cycle's ``rollout.end`` mark to its ``cycle.end`` mark (the program's
device marks, ``fsrl_torch.utils.profiling``)."""

from portbench.program_trace import cycle_ms


def read(rec: dict):
    return cycle_ms(rec, "rollout.end", "cycle.end")
