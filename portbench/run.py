"""Run one cell of ``BENCHMARK.json``:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the result as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics), ``device``
(with ``--trace 1`` also ``busy_s`` and ``window_s`` of the traced slice),
``breakdown`` (traced runs) and, last, ``checked``: each number the
comparison with the reference took, with its limit. Those numbers are also
the last lines of standard error.

Exits non-zero, printing no result, without a CUDA device (or with fewer
than the cell asks for), and if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CACHE = REPO / ".portbench_cache"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # every kernel cache of a run inside the checkout, at a fixed path
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(CACHE / "torch_kernels")
    sys.path.insert(0, str(REPO))

    import torch

    from portbench import harness

    bench = harness.load_json(REPO / "BENCHMARK.json")
    (cell,) = [w for w in bench["workloads"] if w["name"] == args.workload]
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"portbench: the cell needs {cell['chips']} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                           bool(args.trace), T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package were loaded: "
              f"{found}", file=sys.stderr)
        return 3
    for k, v in out["checked"].items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
