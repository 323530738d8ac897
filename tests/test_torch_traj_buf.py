"""The port's ``TrajectoryBuffer`` and native grid filter against the JAX
package's, on ``tests/test_traj_buf.py``'s segments: the same episodes,
trajectories and metrics (also through the grid filter), the C++ filter's
indices at seed 0, the plain numpy filter's breadth-first coverage, and
the HDF5 round trip."""

import numpy as np
import pytest
import torch
from test_traj_buf import seg

from fsrl_torch.data.traj_buf import KEYS, TrajectoryBuffer
from fsrl_torch.native import grid_filter_native
from fsrl_torch.types import Transition
from fsrl_tpu.data.traj_buf import TrajectoryBuffer as JTrajectoryBuffer
from fsrl_tpu.native import grid_filter_native as j_grid_filter_native


def tseg(*args, **kw) -> Transition:
    """``test_traj_buf.seg`` as the port's Transition of tensors."""
    s = seg(*args, **kw)
    return Transition(**{k: torch.from_numpy(np.asarray(getattr(s, k)))
                         for k in ("obs", "act", "obs_next", "reward", "cost",
                                   "terminated", "truncated", "logp")})


def _assert_same_buffers(tb, jb):
    assert tb.num_trajectories == jb.num_trajectories and len(tb) == len(jb)
    for t, j in zip(tb.buffer, jb.buffer):
        assert set(t) == set(j) == set(KEYS)
        for k in KEYS:
            assert t[k].dtype == j[k].dtype, k
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    np.testing.assert_array_equal(np.asarray(tb.metrics),
                                  np.asarray(jb.metrics))


def test_store_segment_matches_jax():
    tb = TrajectoryBuffer(max_trajectory=100, use_grid_filter=False)
    jb = JTrajectoryBuffer(max_trajectory=100, use_grid_filter=False)
    assert tb.store_segment(tseg(12, 3, ep_len=5)) == \
        jb.store_segment(seg(12, 3, ep_len=5)) == 6
    # the partial episodes carried into the next segment
    trunc = np.zeros((3, 3), bool)
    trunc[2, :] = True
    s2 = seg(3, 3, ep_len=5)
    s2 = type(s2)(**{**{k: getattr(s2, k) for k in
                        ("obs", "act", "obs_next", "reward", "cost",
                         "terminated", "logp")}, "truncated": trunc})
    t2 = tseg(3, 3, ep_len=5)
    t2.truncated = torch.from_numpy(trunc)
    assert tb.store_segment(t2) == jb.store_segment(s2) == 3
    _assert_same_buffers(tb, jb)
    np.testing.assert_array_equal(tb.get_all()["rewards"],
                                  jb.get_all()["rewards"])


def test_acceptance_range_matches_jax():
    kw = dict(max_trajectory=100, use_grid_filter=False, rmin=0.0, rmax=3.0,
              cmax=1.0)
    tb, jb = TrajectoryBuffer(**kw), JTrajectoryBuffer(**kw)
    for rew, cost in ((1.0, 0.0), (0.5, 0.0), (0.5, 0.3), (0.2, 0.1)):
        tb.store_segment(tseg(5, 2, ep_len=5, rew=rew, cost=cost))
        jb.store_segment(seg(5, 2, ep_len=5, rew=rew, cost=cost))
    assert tb.num_trajectories == 4
    _assert_same_buffers(tb, jb)


def test_grid_filter_trigger_matches_jax():
    """Over capacity the buffer grows to ``filter_interval *
    max_trajectory`` and is filtered back, by the C++ filter at seed 0 on
    both sides: the same episodes survive, in the same order."""
    kw = dict(max_trajectory=10, use_grid_filter=True, filter_interval=1.5)
    tb, jb = TrajectoryBuffer(**kw), JTrajectoryBuffer(**kw)
    rng = np.random.RandomState(1)
    for _ in range(30):
        r, c = rng.rand() * 10, rng.rand() * 10
        tb.store_segment(tseg(5, 1, ep_len=5, rew=r, cost=c))
        jb.store_segment(seg(5, 1, ep_len=5, rew=r, cost=c))
    assert tb.num_trajectories <= 15
    _assert_same_buffers(tb, jb)


@pytest.mark.parametrize("n_pts,target", [(5050, 256), (300, 64), (40, 64)])
def test_native_filter_matches_jax_native(n_pts, target):
    rng = np.random.RandomState(2)
    pts = np.concatenate([rng.randn(n_pts - n_pts // 100, 2) * 0.1,
                          rng.uniform(5, 50, (n_pts // 100, 2))])
    want = j_grid_filter_native(pts, target, seed=0)
    if want is None:
        pytest.fail("the JAX package's native grid filter did not build")
    got = grid_filter_native(pts, target, seed=0)
    assert got == want
    assert len(got) == min(n_pts, target) == len(set(got))


def test_numpy_filter_is_breadth_first():
    """The plain version: every occupied cell gives a point before any
    cell gives two, so the sparse far points all survive, and it covers
    as many cells as the C++ filter."""
    rng = np.random.RandomState(1)
    pts = np.concatenate([rng.randn(2000, 2) * 0.1,
                          rng.uniform(5, 50, size=(30, 2))])
    kept = TrajectoryBuffer.filter_points(pts, 100,
                                          np.random.default_rng(0))
    assert len(kept) == 100 == len(set(kept))
    assert sum(1 for i in kept if i >= 2000) == 30
    g = int(np.ceil(np.sqrt(100)))
    lo, span = pts.min(0), np.maximum(pts.max(0) - pts.min(0), 1e-12)
    cell = lambda idx: {tuple(c) for c in np.minimum(
        (pts[idx] - lo) / span * g, g).astype(int)}
    assert cell(kept) == cell(np.arange(len(pts)))
    assert cell(kept) == cell(grid_filter_native(pts, 100))
    assert TrajectoryBuffer.filter_points([[0.0, 0.0], [1.0, 1.0]], 5) == \
        [0, 1]


def test_replacement_draws_from_the_buffer_generator():
    """Full and unfiltered: a new episode replaces one drawn from the
    buffer's generator, so two buffers with one seed agree."""
    bufs = [TrajectoryBuffer(max_trajectory=3, use_grid_filter=False,
                             rng=np.random.default_rng(5)) for _ in range(2)]
    for b in bufs:
        for i in range(8):
            b.store_segment(tseg(5, 1, ep_len=5, rew=float(i)))
    assert bufs[0].num_trajectories == 3
    np.testing.assert_array_equal(np.asarray(bufs[0].metrics),
                                  np.asarray(bufs[1].metrics))
    batch = bufs[0].sample(16)
    assert batch["observations"].shape == (16, 3)


def test_hdf5_roundtrip(tmp_path):
    pytest.importorskip("h5py")
    tb = TrajectoryBuffer(max_trajectory=100, use_grid_filter=False)
    tb.store_segment(tseg(10, 2, ep_len=5, rew=2.0, cost=0.5))
    data = TrajectoryBuffer.load(tb.save(str(tmp_path)))
    assert set(data) == set(KEYS)
    want = tb.get_all()
    for k in KEYS:
        np.testing.assert_array_equal(data[k], want[k])
    assert float(data["costs"].sum()) == 10.0 and data["timeouts"].sum() == 4


def test_package_data_covers_the_native_source():
    """An installed copy must be able to build the grid filter: every file
    under ``fsrl_torch/native`` but the loader matches one of the
    package-data globs of ``pyproject.toml``."""
    import fnmatch
    import tomllib
    from pathlib import Path

    import fsrl_torch.native as native
    root = Path(__file__).resolve().parent.parent
    cfg = tomllib.loads((root / "pyproject.toml").read_text())
    globs = cfg["tool"]["setuptools"]["package-data"]["fsrl_torch"]
    sources = [p for p in native.SOURCE.parent.iterdir()
               if p.suffix not in (".py", ".pyc") and p.is_file()]
    assert native.SOURCE in sources
    for p in sources:
        rel = f"native/{p.name}"
        assert any(fnmatch.fnmatch(rel, g) for g in globs), \
            f"{rel} is not packaged by {globs}"
