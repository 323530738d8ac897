"""``kernels.k2_roofline_pct``: K2's least time at the cell's minibatch
(``portbench/flops/k2.py``) over its mean device time a launch in the
traced slice. K2's launches are the kernels whose name holds the
configuration's ``k2_kernel``."""

from portbench.flops import k2, ppo_lag


def read(rec: dict):
    prof, cfg = rec.get("profile"), rec["config"]
    if not prof or "k2_kernel" not in cfg:
        return None
    times = [t for name, ts in prof["kernels"].items()
             if cfg["k2_kernel"] in name for t in ts]
    if not times:
        return None
    bound = k2.bound_s(*ppo_lag.shapes(cfg),
                       ppo_lag.minibatch_rows(cfg, rec["traffic"]),
                       cfg["compute_dtype"] == "bfloat16", rec["peaks"])
    return 100.0 * bound / (sum(times) / len(times))
