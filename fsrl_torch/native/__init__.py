"""Host-side C++ of the port, loaded with ctypes: the trajectory buffer's
grid-density filter (``grid_filter.cpp``, the JAX package's filter).

On first use in a process the source is compiled with ``g++ -O2 -shared
-fPIC`` into ``fsrl_torch/_build`` (listed in ``.gitignore``), under a name
that carries the source's hash. A failed build raises: unlike the JAX
package, the port does not fall back to the numpy filter on its own
(``TrajectoryBuffer.filter_points`` is that plain version, called by name).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "grid_filter.cpp"
BUILD = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]


def build() -> Path:
    """Compile the filter (once per source hash); return the library."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    so = BUILD / f"libgridfilter_{digest.hexdigest()[:16]}.so"
    if so.exists():
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) for the grid filter")
    BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        out = Path(tmp) / so.name
        res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(out), str(SOURCE)],
                             capture_output=True, text=True, timeout=120)
        if res.returncode != 0:
            raise RuntimeError(f"building the grid filter failed\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(out, so)
    return so


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.grid_filter.restype = ctypes.c_long
    lib.grid_filter.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_long, ctypes.c_long,
        ctypes.c_uint, ctypes.POINTER(ctypes.c_long)]
    return lib


def grid_filter_native(points: np.ndarray, target_size: int,
                       seed: int = 0) -> list[int]:
    """Indices of at most ``target_size`` of the 2-D ``points`` that keep
    their grid coverage: one point of every occupied cell of a
    ~sqrt(target)-per-side grid first, then points of random occupied
    cells (``std::mt19937(seed)``)."""
    pts = np.ascontiguousarray(points, dtype=np.float64).reshape(-1, 2)
    out = np.empty(max(target_size, 1), dtype=np.int64)
    kept = library().grid_filter(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_long(pts.shape[0]), ctypes.c_long(target_size),
        ctypes.c_uint(seed),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_long)))
    return out[:kept].tolist()
