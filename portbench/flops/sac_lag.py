"""Model FLOPs of a SAC-Lag dispatch (``fuse_iters`` cycles of a collect
and its grad steps), from shapes. A product of ``(rows, a) x (a, b)`` is
``2 rows a b`` FLOP; a backward pass costs a weight-gradient product per
layer and an input-gradient product for every layer whose input needs
one.

Per collect: the policy's forward pass (trunk, mean and log-sigma heads)
on the ``N T`` observations. Per grad step, on ``batch_size`` rows:

* target: the policy and the target critics forward at the terminal
  observation;
* critics: forward, weight gradients, input gradients past the first
  layer;
* actor: the policy forward, the critics forward and their input
  gradients down to the action, the policy's weight gradients and its
  input gradients past the first layer.

The temperature's step and the Polyak update are elementwise.
"""

from __future__ import annotations


def grad_step_flops(cfg: dict) -> int:
    t, kw = cfg["task"], cfg["algorithm_kwargs"]
    D, A, towers = t["obs_dim"], t["act_dim"], 2 * (1 + t["num_costs"])
    H1, H2 = kw["hidden_sizes"]
    actor_f = 2 * (D * H1 + H1 * H2 + 2 * H2 * A)
    actor_in = 2 * (H1 * H2 + 2 * H2 * A)
    q_first = towers * 2 * (D + A) * H1
    q_deep = towers * 2 * (H1 * H2 + H2)
    q_f = q_first + q_deep
    target = actor_f + q_f
    critic = q_f + q_f + q_deep
    actor = actor_f + q_f + q_f + actor_f + actor_in
    return kw["batch_size"] * (target + critic + actor)


def dispatch_flops(cfg: dict, traffic: dict) -> int:
    t, kw = cfg["task"], cfg["algorithm_kwargs"]
    D, A = t["obs_dim"], t["act_dim"]
    H1, H2 = kw["hidden_sizes"]
    rows = traffic["n_envs"] * traffic["steps_per_collect"]
    n_updates = max(1, round(traffic["update_per_step"] * rows))
    policy = rows * 2 * (D * H1 + H1 * H2 + 2 * H2 * A)
    return traffic["fuse_iters"] * (policy
                                    + n_updates * grad_step_flops(cfg))
