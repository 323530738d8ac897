"""``device.idle_pct``: the share of the traced slice's wall time in which
no operation ran on the device (the union of the device operations'
intervals, from the profiler's trace)."""


def read(rec: dict):
    prof = rec.get("profile")
    if not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
