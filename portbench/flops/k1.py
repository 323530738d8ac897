"""Kernel K1 (GAE over the reward and cost channels): per element of the
``(T, N, K)`` segment, six FLOP; four float32 inputs read and two outputs
written once (``5 * 4`` bytes counting the next values' mask with them),
plus the ``(T, N)`` end flags. Bound by the bytes."""

from __future__ import annotations


def bound_s(T: int, N: int, K: int, peaks: dict) -> float:
    nbytes = 5 * 4 * T * N * K + T * N
    return max(nbytes / peaks["hbm_bytes_per_s"],
               6 * T * N * K / peaks["f32_flop_per_s"])
