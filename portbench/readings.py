"""The readings that the limits of ``limits/<cell>.json`` are set from, on
the card at the cell's own size (the benchmark's runs do not run this):

    python3 -m portbench.readings --workload <cell> --seeds 1 2 3 ... \
        [--controls 3] [--out <file.jsonl>]

For each seed: the program's set-up (its first dispatches, the cycles the
check reads, the replay held against the first dispatch) against the
reference (the sound readings); and on the first
``--controls`` seeds the control (the reference with TF32 products) and
the planted fault of half of each minibatch left out (the reference
training on half of it), each put in the program's place. One JSON line
per seed and side.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(REPO))

    import torch

    from portbench import compare, harness
    from portbench.drivers.common import CHECKED_STEPS

    bench = harness.load_json(REPO / "BENCHMARK.json")
    files = harness.cell_files(bench, args.workload)
    cfg, traffic = files["config"], files["traffic"]
    driver = importlib.import_module(f"portbench.drivers.{cfg['driver']}")
    ref_mod = importlib.import_module(
        f"portbench.reference.{cfg['algorithm']}")
    out = open(args.out, "a") if args.out else None

    def emit(rec: dict) -> None:
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        prog = driver.Program(cfg, traffic, seed, "cuda")
        prog.check_dispatches()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        readings, weights = prog.readings, prog.weights
        prog.free()
        t1 = time.perf_counter()
        ref = ref_mod.run(cfg, traffic, weights, seed, "cuda",
                          checked=CHECKED_STEPS)
        ref_s = time.perf_counter() - t1
        emit(dict(cell=args.workload, seed=seed, side="program",
                  setup_s=setup_s, reference_s=ref_s,
                  **compare.gaps(readings, ref),
                  replay_paths=readings["replay_differs"][:20],
                  detail=compare.detail(readings, ref)))
        if i >= args.controls:
            continue
        for side, kw in (("control_tf32", dict(tf32=True)),
                         ("fault_half_batch", dict(half_batch=True))):
            alt = ref_mod.run(cfg, traffic, weights, seed, "cuda",
                              checked=CHECKED_STEPS, **kw)
            alt = dict(alt, params0=readings["params0"])
            emit(dict(cell=args.workload, seed=seed, side=side,
                      **compare.gaps(alt, ref),
                      detail=compare.detail(alt, ref)))
    print(json.dumps(dict(card=torch.cuda.get_device_name(0))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
