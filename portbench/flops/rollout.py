"""The rollout kernel (``fsrl_torch/csrc/rollout.cu``): the operations and
bytes of one launch, a whole ``(T, N)`` segment, and the least time the
card could take for them.

Per env step the actor's forward pass: ``2 (D H1 + H1 H2 + H2 A)`` FLOP of
f32 FMAs on the FP32 pipes (the kernel never uses TF32). Bytes: the
segment's transitions written, each env step's observation and next
observation, action, reward, log-prob and costs in f32 and its two flags
in one byte each. The env arithmetic, the draws read and the weights are
left out; the products bound the kernel by a factor of about twenty.
"""

from __future__ import annotations


def flops(N: int, T: int, D: int, H1: int, H2: int, A: int) -> int:
    return 2 * N * T * (D * H1 + H1 * H2 + H2 * A)


def nbytes(N: int, T: int, D: int, A: int, M: int) -> int:
    return N * T * (4 * (2 * D + A + 2 + M) + 2)


def bound_s(cfg: dict, traffic: dict, peaks: dict) -> float:
    """The larger of the operations' and the bytes' least time, at the
    configuration's widths and the traffic's segment."""
    t = cfg["task"]
    h1, h2 = cfg["algorithm_kwargs"]["hidden_sizes"]
    N, T = traffic["n_envs"], traffic["steps_per_collect"]
    D, A, M = t["obs_dim"], t["act_dim"], t["num_costs"]
    return max(flops(N, T, D, h1, h2, A) / peaks["f32_flop_per_s"],
               nbytes(N, T, D, A, M) / peaks["hbm_bytes_per_s"])
