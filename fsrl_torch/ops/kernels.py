"""Build, load and count the port's hand-written CUDA kernels.

The sources live in ``fsrl_torch/csrc``. On first use in a process they are
compiled for Hopper (``sm_90a``) with ``nvcc``, one compiler process per
source started together, linked into one shared library with a plain C
interface under ``fsrl_torch/_build`` (listed in ``.gitignore``), and loaded
with ``ctypes``. A library whose name carries the sources' hash is reused.

Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.

Each kernel wrapper adds one to ``LAUNCHES[name]`` where it launches its
kernel and nowhere else, so a run can show that its main path went through
the kernels. The trace's device marks (``marks.cu``, launched by
:mod:`fsrl_torch.utils.profiling`) are not counted there.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import json
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
SOURCES = ("gae.cu", "fused_ppo_grad.cu", "fused_ppo_grad_f32.cu",
           "fused_ppo_grad_any.cu", "marks.cu", "rollout.cu")
HEADERS = ("wgmma.cuh", "ppo_grad_common.cuh", "mma_tf32.cuh")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES: collections.Counter = collections.Counter()
# the compiler's output for each source of the library (ptxas' register and
# spill report), kept beside it as JSON so that a reused library has it too
BUILD_LOG: dict[str, str] = {}


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit on the machine with the card")
    return nvcc


def build(verbose: bool = False) -> Path:
    """Compile the sources (in parallel) and link the shared library;
    return its path. ``verbose`` prints ptxas' register/spill report."""
    digest = hashlib.sha256()
    for s in SOURCES + HEADERS:
        digest.update((CSRC / s).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    so = BUILD / f"libfsrl_kernels_{digest.hexdigest()[:16]}.so"
    log = so.with_suffix(".log.json")
    if so.exists():
        if log.exists():
            BUILD_LOG.update(json.loads(log.read_text()))
        return so
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        objs, procs = [], []
        for s in SOURCES:
            obj = Path(tmp) / (s + ".o")
            objs.append(str(obj))
            procs.append((s, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for s, p in procs:
            out, _ = p.communicate()
            BUILD_LOG[s] = out
            if verbose and out:
                print(f"[nvcc {s}]\n{out}", flush=True)
            if p.returncode != 0:
                failed.append(f"{s}:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed\n" + "\n".join(failed))
        tmp_so = Path(tmp) / so.name
        res = subprocess.run([nvcc, "-shared", "-o", str(tmp_so), *objs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed\n{res.stdout}{res.stderr}")
        log.write_text(json.dumps(BUILD_LOG))
        os.replace(tmp_so, so)
    return so


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call in the process)."""
    lib = ctypes.CDLL(str(build()))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fsrl_gae.argtypes = [P, P, P, P, P, P, I, I, I, F, F, P]
    lib.fsrl_gae.restype = I
    lib.fsrl_ppo_grad.argtypes = [P] * 11 + [I] * 6 + [ctypes.c_long,
                                                       F, F, F, P]
    lib.fsrl_ppo_grad.restype = I
    lib.fsrl_ppo_grad_scratch_floats.argtypes = [I, I, I, I, I]
    lib.fsrl_ppo_grad_scratch_floats.restype = ctypes.c_long
    lib.fsrl_ppo_grad_reduce_only.argtypes = [P, P, P, I, I, I, I, P]
    lib.fsrl_ppo_grad_reduce_only.restype = I
    lib.fsrl_ppo_grad_blocks.argtypes = [I, I]
    lib.fsrl_ppo_grad_smem_bytes.argtypes = [I, I, I, I]
    lib.fsrl_ppo_grad_smem_bytes.restype = ctypes.c_long
    lib.fsrl_ppo_grad_tile_offset.argtypes = [I, I, I]
    lib.fsrl_ppo_grad_any.argtypes = [P] * 11 + [I] * 7 + [ctypes.c_long,
                                                          F, F, F, P]
    lib.fsrl_ppo_grad_any.restype = I
    lib.fsrl_ppo_grad_any_scratch_floats.argtypes = [I] * 6
    lib.fsrl_ppo_grad_any_scratch_floats.restype = ctypes.c_long
    lib.fsrl_ppo_grad_any_one.argtypes = [P] * 11 + [I] * 7 + [
        ctypes.c_long, F, F, F, P, I]
    lib.fsrl_ppo_grad_any_one.restype = I
    lib.fsrl_ppo_grad_any_splits.argtypes = [I] * 7
    lib.fsrl_ppo_grad_any_row_blocks.argtypes = [I] * 7
    lib.fsrl_ppo_grad_any_retakes.argtypes = [P]
    lib.fsrl_ppo_grad_any_retakes.restype = I
    lib.fsrl_ppo_grad_any_smem_bytes.argtypes = [I]
    lib.fsrl_ppo_grad_any_smem_bytes.restype = ctypes.c_long
    lib.fsrl_ppo_grad_f32_retakes.argtypes = [P]
    lib.fsrl_ppo_grad_f32_retakes.restype = I
    lib.fsrl_gae_strip.argtypes = []
    lib.fsrl_gae_time_tile.argtypes = []
    lib.fsrl_empty_launch.argtypes = [P]
    lib.fsrl_empty_launch.restype = I
    # the collector's segment (fsrl_torch.ops.rollout_kernel)
    lib.fsrl_rollout.argtypes = [P, P, I, I, I, I, P]
    lib.fsrl_rollout.restype = I
    lib.fsrl_rollout_struct_bytes.argtypes = [I]
    # the trace's device marks (fsrl_torch.utils.profiling)
    lib.fsrl_mark.argtypes = [I, I, P]
    lib.fsrl_mark.restype = I
    lib.fsrl_marks_capacity.argtypes = []
    lib.fsrl_marks_capacity.restype = ctypes.c_long
    lib.fsrl_marks_read.argtypes = [P, P]
    lib.fsrl_marks_read.restype = I
    lib.fsrl_marks_clock.argtypes = [P]
    lib.fsrl_marks_clock.restype = I
    lib.fsrl_marks_clock_read.argtypes = [P]
    lib.fsrl_marks_clock_read.restype = I
    return lib


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream


def empty_launch() -> None:
    """Launch a kernel that does nothing on the current stream: timed, it
    is what a launch costs on its own. Not counted in ``LAUNCHES``."""
    check(library().fsrl_empty_launch(stream_ptr()), "empty kernel")


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch "
                           f"({torch.cuda.get_device_name()})")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)
