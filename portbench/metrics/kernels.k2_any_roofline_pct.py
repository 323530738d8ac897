"""``kernels.k2_any_roofline_pct``: K2's least time at the cell's minibatch
(``portbench/flops/k2.py``) over the mean device time of one call of K2's
generic form in the traced slice. A call is three launches, ``row_kernel``,
``wgrad_kernel`` and ``reduce_kernel``, of the namespace that the
configuration's ``k2_any_kernels`` names (``ppo_any::``): their times
summed over the slice, over the number of ``row_kernel`` launches. ATen's
own ``reduce_kernel`` lies in another namespace and does not count."""

from portbench.flops import k2, ppo_lag

LAUNCHES = ("row_kernel", "wgrad_kernel", "reduce_kernel")


def function(name: str) -> str:
    """A device kernel's qualified function name, from the profiler's
    signature: ``void ns::(anonymous namespace)::f<...>(...)`` gives
    ``ns::f``."""
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0].split()[-1]


def read(rec: dict):
    prof, cfg = rec.get("profile"), rec["config"]
    if not prof or "k2_any_kernels" not in cfg:
        return None
    ns = cfg["k2_any_kernels"]
    total, calls = 0.0, 0
    for name, times in prof["kernels"].items():
        fn = function(name)
        if not fn.startswith(ns) or fn[len(ns):] not in LAUNCHES:
            continue
        total += sum(times)
        calls += len(times) if fn[len(ns):] == "row_kernel" else 0
    if not calls:
        return None
    bound = k2.bound_s(*ppo_lag.shapes(cfg),
                       ppo_lag.minibatch_rows(cfg, rec["traffic"]),
                       cfg["compute_dtype"] == "bfloat16", rec["peaks"])
    return 100.0 * bound / (total / calls)
