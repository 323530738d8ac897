"""The readers of the program's own trace (``portbench/program_trace.py``
and the five ``metrics/`` files that use it) on a hand-made record: each
reads the traced run's window dispatches alone, and finds nothing where
the program records no trace."""

import pytest

from fsrl_torch.utils import profiling
from portbench import harness

MS = 1_000_000
# the entries that would list these readers in BENCHMARK.json
ENTRIES = [
    dict(name="collector.rollout_device_ms", unit="ms", better="lower",
         source="device_trace", layer="collector", moves="env_steps_per_s"),
    dict(name="update.device_ms", unit="ms", better="lower",
         source="device_trace", layer="update", moves="env_steps_per_s"),
    dict(name="trainer.dispatch_gap_ms", unit="ms", better="lower",
         source="device_trace", layer="trainer", moves="env_steps_per_s"),
    dict(name="graphs.launch_host_ms", unit="ms", better="lower",
         source="host_clock", layer="graphs", moves="env_steps_per_s"),
    dict(name="collector.host_ms", unit="ms", better="lower",
         source="host_clock", layer="collector", moves="env_steps_per_s",
         workloads=["sacl-chunk256"]),
]


def _record(dispatches=6, cycles=2):
    """Dispatch d starts at d seconds; its cycles take 100 ms each: a
    rollout of d * 10 ms, the rest the update. It launches two graphs of d
    ms each and collects for 5 d ms on the host."""
    spans, marks, sid, seq = [], [], 0, 0
    for d in range(1, dispatches + 1):
        t0 = d * 1000 * MS
        top = sid
        for k in range(2):
            sid += 1
            spans.append(profiling.Span(sid, "graphs.replay", t0 + k * MS,
                                        t0 + k * MS + d * MS, top, d, "g"))
        sid += 1
        spans.append(profiling.Span(sid, "collector.collect", t0,
                                    t0 + 5 * d * MS, top, d))
        for c in range(cycles):
            c0 = t0 + c * 100 * MS
            for name, at in zip(profiling.MARKS,
                                (0, 10 * d, 10 * d + 5, 90)):
                marks.append(profiling.Mark(seq, name, c, d, c0 + at * MS))
                seq += 1
        spans.append(profiling.Span(top, "trainer.dispatch", t0,
                                    t0 + 900 * MS, None, d))
        sid += 1
    return profiling.Record(spans, marks, None)


def _rec(n=3, p=2):
    return dict(window=dict(dispatches=n, seconds=1.0),
                traffic=dict(profile_dispatches=p))


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(profiling, "record", _record)


# the window is dispatches 2, 3, 4 of 6 (the last two are the profiled
# slice's)
@pytest.mark.parametrize("name,want", [
    ("collector.rollout_device_ms", 30.0),
    ("update.device_ms", 60.0),
    ("trainer.dispatch_gap_ms", 810.0),
    ("graphs.launch_host_ms", 6.0),
    ("collector.host_ms", 15.0),
])
def test_each_reader_reads_the_window_alone(recorded, name, want):
    assert harness.load_reader(name)(_rec()) == pytest.approx(want)


@pytest.mark.parametrize("name", [e["name"] for e in ENTRIES])
def test_a_reader_finds_nothing_without_the_programs_trace(
        monkeypatch, name):
    monkeypatch.delattr(profiling, "record")
    assert harness.load_reader(name)(_rec()) is None


@pytest.mark.parametrize("name", [e["name"] for e in ENTRIES])
def test_a_reader_finds_nothing_in_too_few_dispatches(recorded, name):
    assert harness.load_reader(name)(_rec(n=6, p=2)) is None


def test_the_entries_give_every_value_a_traced_run_requires(recorded):
    bench = dict(per_layer=ENTRIES)
    for cell, n in (("sacl-chunk256", 5), ("ppol-f32-fuse8", 4)):
        out = harness.per_layer(bench, cell, _rec(), required=True)
        assert len(out) == n
        assert all(v["unit"] == "ms" for v in out.values())
