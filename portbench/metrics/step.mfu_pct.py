"""``step.mfu_pct``: the model FLOPs of the dispatches in the traced run's
unprofiled window (``portbench/flops/<algorithm>.py``) over the window's
host-clock time, as a share of the peak the configuration states."""

import importlib


def read(rec: dict):
    cfg, win = rec["config"], rec["window"]
    if win["seconds"] <= 0:
        return None
    flops = importlib.import_module(f"portbench.flops.{cfg['algorithm']}")
    rate = (flops.dispatch_flops(cfg, rec["traffic"]) * win["dispatches"]
            / win["seconds"])
    return 100.0 * rate / rec["peaks"][cfg["peak"]["key"]]
