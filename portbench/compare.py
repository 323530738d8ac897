"""The numbers that decide ``correct``: the program's first steps against
the reference's.

* ``loss_gap``: the relative gap of the first loss the program reports
  (PPO-Lag: its first update's mean minibatch loss; SAC-Lag: its first
  grad step's critic loss);
* ``grad_gap``: the first gradient as the optimizers get it, by the worst
  leaf (``grad_gap_median``: by the median leaf);
* ``change_gap``: the parameters' change over the first three grad steps,
  by the worst leaf (``change_gap_median``: by the median leaf);
* ``multiplier_gap``: the PID multiplier that each of the first three
  updates (PPO-Lag) or grad steps (SAC-Lag) trains with, the widest gap
  over the reference's largest multiplier of those steps;
* ``replay_differs``: how many of the program's tensors (its state and
  its metrics) differ in a single bit between a replayed dispatch and the
  eager first dispatch from the same start (exact: limit 0).

A leaf's gap: ``| ||program leaf|| - ||reference leaf|| |`` over the
larger of the reference leaf's norm and the median leaf's. A leaf whose
reference gradient's norm is under a thousandth of the median leaf's (its
gradient is nought to rounding) is left out. A cell's
``limits/<cell>.json`` names the numbers it compares.
"""

from __future__ import annotations

import math
import statistics

import torch

NEGLIGIBLE = 1e-3


def _norms(leaves: dict) -> dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.detach().double()))
            for k, v in leaves.items()}


def kept_leaves(ref_grad: dict) -> list[str]:
    norms = _norms(ref_grad)
    floor = NEGLIGIBLE * statistics.median(norms.values())
    return [k for k, n in norms.items() if n >= floor]


def leaf_gaps(prog: dict, ref: dict, keep: list[str]) -> dict[str, float]:
    """Each kept leaf's gap."""
    p, r = _norms({k: prog[k] for k in keep}), _norms({k: ref[k]
                                                        for k in keep})
    med = statistics.median(r.values())
    return {k: abs(p[k] - r[k]) / max(r[k], med, 1e-30) for k in keep}


def detail(prog: dict, ref: dict) -> dict:
    """What :func:`gaps` takes the worst of: the losses side by side, and
    each leaf's gaps."""
    keep = kept_leaves(ref["grad"])
    p0 = prog["params0"]
    change = lambda side: {k: side["params"][k].double() - p0[k].double()
                           for k in keep}
    return dict(loss=list(zip(prog["loss"], ref["loss"])),
                multiplier=list(zip(prog["multiplier"], ref["multiplier"])),
                grad=leaf_gaps(prog["grad"], ref["grad"], keep),
                change=leaf_gaps(change(prog), change(ref), keep),
                dropped=sorted(set(ref["grad"]) - set(keep)))


def gaps(prog: dict, ref: dict) -> dict[str, float]:
    """``prog`` and ``ref`` hold ``loss`` and ``multiplier`` (lists of
    floats), ``grad`` and ``params`` (dicts of leaves, by the same names)
    and, for the program, ``params0`` (the leaves it started from, which
    the reference was handed too) and ``replay_differs`` (the paths a
    replay changed)."""
    d = detail(prog, ref)
    (p, r), = d["loss"][:1]
    pm, rm = prog["multiplier"], ref["multiplier"]
    top = max((abs(x) for x in rm), default=0.0)
    mult = (max(abs(a - b) for a, b in zip(pm, rm)) / max(top, 1e-30)
            if len(pm) == len(rm) > 0 else math.inf)
    return dict(loss_gap=abs(p - r) / max(abs(r), 1e-30),
                multiplier_gap=mult,
                replay_differs=float(len(prog.get("replay_differs", []))),
                grad_gap=max(d["grad"].values()),
                grad_gap_median=statistics.median(d["grad"].values()),
                change_gap=max(d["change"].values()),
                change_gap_median=statistics.median(d["change"].values()))


def judge(values: dict[str, float], limits: dict[str, float]) -> bool:
    """Every number the cell's limits name within its limit."""
    return all(math.isfinite(values[k]) and values[k] <= limits[k]
               for k in limits)
