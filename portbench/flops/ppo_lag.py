"""Model FLOPs of a PPO-Lag dispatch (``fuse_iters`` cycles), from shapes.

Per cycle, counted once each (recomputed work is not counted):

* the rollout: the policy's forward pass (trunk and mean head) on every
  one of the ``N T`` observations;
* processing: the K critics' forward pass on the ``(T + 1) N``
  observations of the segment and its last next observation;
* the update: every minibatch's forward and backward pass through the
  actor and the critics, K2's count (:mod:`portbench.flops.k2`).

A product of ``(rows, a) x (a, b)`` is ``2 rows a b`` FLOP.
"""

from __future__ import annotations

from portbench.flops import k2


def shapes(cfg: dict) -> tuple[int, int, int, int, int]:
    t = cfg["task"]
    h1, h2 = cfg["algorithm_kwargs"]["hidden_sizes"]
    return t["obs_dim"], h1, h2, t["act_dim"], 1 + t["num_costs"]


def minibatch_rows(cfg: dict, traffic: dict) -> int:
    """The tile arithmetic of the update: 4096 tiles of ``size // 4096``
    rows, as many whole minibatches of tiles as fit."""
    size = traffic["n_envs"] * traffic["steps_per_collect"]
    n_mb = cfg["algorithm_kwargs"]["n_minibatches"]
    ts = max(1, size // 4096)
    return (size // ts) // n_mb * ts


def cycle_flops(cfg: dict, traffic: dict) -> int:
    D, H1, H2, A, K = shapes(cfg)
    N, T = traffic["n_envs"], traffic["steps_per_collect"]
    kw = cfg["algorithm_kwargs"]
    policy = N * T * 2 * (D * H1 + H1 * H2 + H2 * A)
    critics = (T + 1) * N * K * 2 * (D * H1 + H1 * H2 + H2)
    steps = kw["repeat"] * kw["n_minibatches"]
    update = steps * sum(k2.flops(D, H1, H2, A, K,
                                  minibatch_rows(cfg, traffic)))
    return policy + critics + update


def dispatch_flops(cfg: dict, traffic: dict) -> int:
    return traffic["fuse_iters"] * cycle_flops(cfg, traffic)
