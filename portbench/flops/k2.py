"""Kernel K2 (PPO-Lag's fused minibatch gradient): the operations and
bytes one launch needs, and the least time the card could take for them.

Per row, each tower (the actor with A outputs, K critics with one) runs a
forward and backward pass of its two hidden layers (``6 H1 H2 + 4 D H1``:
the products of the forward pass, the input gradient of layer 2 and both
weight gradients) and of its head (``6 H2 out``). bf16 runs every FLOP at
the bf16 tensor-core rate; f32 runs the products three times at the TF32
rate (the split that keeps f32 accuracy) and the heads on the FP32 pipes.
Bytes: each row's inputs read once (observation, action, old log-prob, K
advantages and returns) and the parameters and their gradient once each.
"""

from __future__ import annotations


def flops(D: int, H1: int, H2: int, A: int, K: int, rows: int
          ) -> tuple[int, int]:
    """``(products, heads)`` FLOP of one launch."""
    outs = [A] + [1] * K
    mm = rows * sum(6 * H1 * H2 + 4 * D * H1 for _ in outs)
    heads = rows * sum(6 * H2 * o for o in outs)
    return mm, heads


def n_params(D: int, H1: int, H2: int, A: int, K: int) -> int:
    """The actor (trunk, mean head, log-sigma) and K critic towers."""
    actor = D * H1 + H1 + H1 * H2 + H2 + H2 * A + A + A
    critic = D * H1 + H1 + H1 * H2 + H2 + H2 + 1
    return actor + K * critic


def nbytes(D: int, H1: int, H2: int, A: int, K: int, rows: int) -> int:
    return 4 * (rows * (D + A + 1 + 2 * K)
                + 2 * n_params(D, H1, H2, A, K) + 8)


def bound_s(D: int, H1: int, H2: int, A: int, K: int, rows: int,
            bf16: bool, peaks: dict) -> float:
    """The larger of the operations' and the bytes' least time."""
    mm, heads = flops(D, H1, H2, A, K, rows)
    if bf16:
        ops_s = (mm + heads) / peaks["bf16_flop_per_s"]
    else:
        ops_s = (3 * mm / peaks["tf32_flop_per_s"]
                 + heads / peaks["f32_flop_per_s"])
    return max(ops_s, nbytes(D, H1, H2, A, K, rows)
               / peaks["hbm_bytes_per_s"])
