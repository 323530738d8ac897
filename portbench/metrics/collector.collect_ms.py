"""``collector.collect_ms``: the mean host-clock time of the off-policy
trainer's ``collect()`` in the traced run's window, each span started and
ended on a drained device."""


def read(rec: dict):
    spans = rec["spans"].get("collect")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
