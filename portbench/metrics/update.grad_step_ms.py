"""``update.grad_step_ms``: the mean host-clock time of the off-policy
trainer's ``update()`` in the traced run's window (spans as
``collector.collect_ms``'s), over its grad steps a collect."""


def read(rec: dict):
    spans = rec["spans"].get("update")
    if not spans:
        return None
    t = rec["traffic"]
    steps = max(1, round(t["update_per_step"] * t["n_envs"]
                         * t["steps_per_collect"]))
    return 1e3 * sum(spans) / len(spans) / steps
