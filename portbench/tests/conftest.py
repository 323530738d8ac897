"""The benchmark's CPU tests: ``python -m pytest portbench/tests -q``
from the repo's root. Tests marked ``cuda`` need the card and skip
elsewhere (they decide inside the test)."""

import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# the tiny sizes the CPU runs take in place of a cell's traffic
TINY = {
    "ppol-carcircle-f32": {"n_envs": 256, "steps_per_collect": 32,
                           "fuse_iters": 4, "dispatch_mode": "",
                           "profile_dispatches": 1},
    "sacl-ballcircle-f32": {"n_envs": 8, "steps_per_collect": 25,
                            "fuse_iters": 1, "buffer_size": 400,
                            "update_per_step": 0.2, "update_chunk": 16,
                            "fill_collects": 2, "dispatch_mode": "",
                            "spans": ["collect", "update"],
                            "profile_dispatches": 1},
}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
