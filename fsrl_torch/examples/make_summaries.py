"""Regenerate the per-task summary tables from the result JSONs in a
results directory (port of ``benchmarks/make_summaries.py``): every
``summary-<task>.md`` is rewritten from all of the directory's JSONs.

For a run recorded before the ``best_*`` fields existed, the
feasibility-first best (the reference's model-selection rule) is
reconstructed from its per-epoch curve.

    python -m fsrl_torch.examples.make_summaries --dirs logs/curves

Unlike the JAX script, this one writes the markdown tables only and draws
no curve plots (it needs no matplotlib), and its default directory is the
runner's own, under ``logs/``.
"""

from __future__ import annotations

import glob
import json
import os
from collections import defaultdict
from dataclasses import dataclass

from fsrl_torch.config.cli import cli


def best_from_curve(curve: dict, limit: float) -> tuple[float, float]:
    """The feasibility-first best (reward, cost) of a per-epoch curve."""
    best_r, best_c, has = -float("inf"), float("inf"), False
    for r, c in zip(curve["reward"], curve["cost"]):
        new_feas, old_feas = c <= limit, best_c <= limit
        better = (new_feas and not old_feas) or (
            new_feas == old_feas and r > best_r)
        if better or not has:
            best_r, best_c, has = r, c, True
    return best_r, best_c


@dataclass
class SumCfg:
    dirs: str = "logs/curves"


def load_dir(d: str) -> dict[str, list]:
    """All result JSONs in ``d``, grouped by task."""
    by_task = defaultdict(list)
    for f in sorted(glob.glob(os.path.join(d, "*.json"))):
        try:
            with open(f) as fh:
                r = json.load(fh)
        except (OSError, ValueError):
            continue
        if isinstance(r, dict) and "algo" in r and "task" in r:
            r["_file"] = os.path.basename(f)
            by_task[r["task"]].append(r)
    return by_task


def summarize_dir(d: str) -> None:
    """Rewrite every ``summary-<task>.md`` in ``d`` from all its JSONs.
    The runner calls this after each invocation, so that runs made one
    cell at a time never leave a stale summary."""
    for task, rows in load_dir(d).items():
        rows.sort(key=lambda r: (r["algo"], r.get("seed", 0), r["_file"]))
        limit = rows[0].get("cost_limit", 25.0)
        md = [f"# Curves: {task} (cost_limit={limit})", "",
              "Best = feasibility-first best test checkpoint (the "
              "reference's model-selection rule); final = evaluation of "
              "the last state. Oscillating Lagrangian methods can end a "
              "run mid-violation — deploy the best checkpoint.", "",
              "| algo | seed | budget | final reward | final cost | "
              "best reward | best cost | steps/s |",
              "|---|---|---|---|---|---|---|---|"]
        for r in rows:
            if "best_reward" not in r and "curve" in r:
                br, bc = best_from_curve(r["curve"], limit)
                r["best_reward"], r["best_cost"] = br, bc
            tag = " (pid-retune)" if "-pid" in r["_file"] else ""
            md.append(
                f"| {r['algo']}{tag} | {r.get('seed', 0)} | "
                f"{r['budget']:,} | {r['final_reward']:.1f} | "
                f"{r['final_cost']:.1f} | {r['best_reward']:.1f} | "
                f"{r['best_cost']:.1f} | {r['steps_per_s']:,.0f} |")
        out = os.path.join(d, f"summary-{task}.md")
        with open(out, "w") as f:
            f.write("\n".join(md) + "\n")
        print("wrote", out)


@cli(SumCfg)
def main(cfg: SumCfg):
    for d in cfg.dirs.split(","):
        if os.path.isdir(d):
            summarize_dir(d)


if __name__ == "__main__":
    main()
