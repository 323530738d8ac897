"""``trainer.dispatch_gap_ms``: the mean device time from a window
dispatch's last mark to the next window dispatch's first mark (the
program's device marks, ``fsrl_torch.utils.profiling``): the card's time
between two dispatches' work, the train log's readback and the next
launch in it."""

from portbench.program_trace import mean_ms, window


def read(rec: dict):
    found = window(rec)
    if found is None:
        return None
    trace, nums = found
    first, last = {}, {}
    for m in trace.marks:
        if m.dispatch in last:
            last[m.dispatch] = max(last[m.dispatch], m.t_ns)
            first[m.dispatch] = min(first[m.dispatch], m.t_ns)
        elif m.dispatch is not None:
            first[m.dispatch] = last[m.dispatch] = m.t_ns
    return mean_ms([first[b] - last[a] for a, b in zip(nums, nums[1:])
                    if a in last and b in first])
