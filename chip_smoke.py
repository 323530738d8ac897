#!/usr/bin/env python3
"""Drive the PyTorch port (``fsrl_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass:

0. build: compile the CUDA kernels from ``fsrl_torch/csrc`` with ``nvcc``
   for ``sm_90a``; K2's shared memory at the paths' shapes and corners, and
   its largest over the whole envelope (D <= 64, A <= 8, K <= 6; fails above
   a block's 232,448 bytes); ptxas' registers and spills of every K2
   instance (fails if an instance that a training path launches spills);
   K2's generic form (``csrc/fused_ppo_grad_any.cu``): every kernel's
   registers and spills, its static shared memory, its scratch at the
   largest cases;
1. train: first one critic loss and gradient in the ensemble's form (a
   plain matmul chain per tower) against one matmul batched over the towers,
   at the whole batch and at one minibatch; then PPO-Lagrangian through the
   agent API on SafetyCarCircle-v0 at the benchmark width (4096 envs x 64
   steps, hidden (128, 128), K = 2 value channels, repeat 4 x 8 minibatches,
   bf16) for 3 iterations plus the episode-exact test; the kernel launch
   counters are zeroed just before and read just after, and both kernels
   must have run; then 3 more iterations are timed; then f32 PPO-Lag, the
   config's default dtype, whose grad steps go through the f32 K2 kernel
   (three TF32 products for each product on the tensor cores): one
   iteration with its launches counted (32), then 3 iterations with
   collect and update timed apart;
   then, each with the launch counters zeroed before and read after, FOCOPS
   on SafetyCarCircle-v0 (repeat 4 x 8 minibatches), TRPO-Lagrangian on
   SafetyDroneRun-v0 (whose crashes terminate episodes) and CPO on
   SafetyAntRun-v0, at the same width, in f32 and in bf16: 3 iterations
   plus the test, then 3 timed iterations with collect and update apart,
   and for f32 the split of one trust-region update;
   then the navigation path: PPO-Lag on SafetyPointGoal1-v0 (observation
   21, K2's widened envelope) at the same width, repeat 4 x 8, in f32 and
   bf16: one iteration with its launches counted (exactly 1 K1 and 32 K2
   of the matching form, 0 of the other; 0 K2 would be the autograd
   fallback), then 3 iterations with collect and update timed; and
   recurrent PPO-Lag (GRU 128, critics (128, 128)) on SafetyPointGoal1-v0
   at 4096 envs x 64 steps: one iteration counted (1 K1, no K2), 3 timed;
   then K2's generic form on the main path: PPO-Lag on SafetyCarCircle-v0
   at the same shape with hidden (256, 256) in f32 and bf16 and (64, 64)
   in f32 (``[train ppo_lag h256 ...]``, ``[train ppo_lag h64 f32]``):
   3 iterations plus the test counted (exactly 3 K1 and 96 launches of
   the generic form of the dtype, none of another K2 form), 3 timed;
   then the host path at the JAX package's velocity protocol over a numpy
   stand-in for HalfCheetah (the card's machine has no gymnasium or
   mujoco): PPO-Lag through ``HostOnpolicyTrainer`` (10 envs x 2000 steps,
   repeat 4 x 78 minibatches of 256 rows, D 17, A 6) in f32 and bf16, one
   epoch counted (exactly 1 K1 and 312 K2 of the matching form), 3
   iterations timed with the collect split into env, policy and transfer;
   the same at Humanoid's observation width with 40 actions (``[train
   host a40 f32|bf16]``: the generic form, 312 launches an epoch), one
   epoch and one timed iteration;
   SAC-Lag through ``HostOffpolicyTrainer`` (4 envs x 100 steps, 80 grad
   steps a collect), one epoch counted (no kernel), 3 timed; the same on
   the real SafetyHalfCheetahVelocity-v1, and a raw-MuJoCo PointGoal1
   epoch, where gymnasium and mujoco import (else one line says so); the
   trajectory buffer's C++ grid filter built and held to its numpy
   version's cell coverage;
2. update parity: one small f32 update of each of the four algorithms on
   the card against the same update on the CPU (plain versions; PPO-Lag's
   4 grad steps through the f32 K2 kernel, counted), and one f32 PPO-Lag
   update on rows of SafetyPointGoal1-v0 (D 21, through the wide f32
   kernel), and one at hidden (64, 32) (``[update parity h64x32]``, 4
   launches of the generic f32 form); then a
   checkpoint of the FOCOPS state trained on the card is loaded into a fresh
   agent, compared tensor by tensor, and trained one more iteration;
3. K1: the GAE kernel against its plain version, bit for bit, at
   (T, N, K) = (64, 4096, 2) and at ragged strips, a T above one time tile
   and a column count that takes the 4-byte path; two launches on the same
   inputs must give identical outputs;
4. K2: the fused PPO-Lag grad kernels against their plain version at
   32768 rows, D = 9, A = 2, H = 128, K = 2 and K = 3 in bf16 (``wgmma``,
   tolerance 1e-2) and K = 2 in f32 (``mma.sync`` with the TF32 split,
   1e-5 of each gradient tensor's largest entry on rows drawn clear of the
   ReLU kinks; each aux entry no farther from a float64 evaluation of the
   plain version than the plain f32 version, plus rtol 1e-5 and 1e-8 a
   row), half the
   rows with ratio == 1 exactly; f32 also on natural rows of three seeds,
   each gradient tensor no farther from the float64 evaluation than the
   plain f32 version plus 1e-5 of its largest entry, each aux entry as
   above; each kernel's time
   split into a cost per chunk and a fixed cost; then both at the
   envelope's edges (1000 and 100 rows, K = 1, K = 6, D = 12 with A = 4, D =
   1) and at the data-parallel path's row counts (16,384, and a
   ``dp_blocks`` 1 minibatch's uneven share); two launches on the same
   inputs must give identical outputs; the reduce launch and an empty kernel
   are timed on their own; both forms at the widened envelope (D 13, 16, 17,
   21, 32, 54, 64 with A 2, K 2; the corner D 64, A 4, K 6; ragged rows at D
   21 and D 54), the f32 kernel on natural rows at D 21 and D 54 against
   float64, both timed at D 21 and
   D 54, and the autograd step PPO-Lag took outside the old envelope timed
   once at D 21; the instances for 5 to 8 actions at D 9, 17 and 64 with
   K 6, at 256 rows and at ragged row counts, and both forms timed at the
   host path's D 17, A 6 at 256 and 32,768 rows; above D 64 and A 8 (D
   65 to 376, A 9 to 32, the corner (348, 17, K 6), 256 rows and ragged
   counts), both forms timed at Ant's (105, 8) and Humanoid's (348, 17) at
   256 and 32,768 rows with their shared memory and registers, the f32
   kernel on Humanoid's natural rows against float64 with its float64
   retakes counted, and the autograd step those widths took before;
   the generic form (``[K2 any ...]``) in both dtypes at ``K2_ANY_CASES``
   (hidden (256, 256), (64, 64), (512, 512) and uneven widths, 33 to 128
   actions, K 1 to 6, D 1 to 348, 100 to 32,768 rows), at the same
   tolerances, two launches bit for bit, timed at (9, 256, 256, 2, 2,
   32768), (9, 64, 64, 2, 2, 32768) and (348, 128, 128, 40, 2, 256); and
   the autograd step the hidden (256, 256) path ran before it
   (``[autograd step h256]``);
5. off-policy: DDPG-Lagrangian, SAC-Lagrangian and CVPO through the agent
   API at the JAX package's off-policy benchmark shape
   (SafetyBallCircle-v0, 32 envs x 100 steps, 0.2 grad steps per env step,
   so 640 grad steps per collect, batch 256, buffer 100,000, hidden
   (128, 128), f32): 2 iterations plus the test with the launch counters
   zeroed before and read after (K1 and K2 are on none of these paths),
   each iteration's collect and update timed apart; one short bf16 SAC-Lag
   run; one ``update_step`` of each algorithm on the card against the CPU
   from the same state with the same injected draws; a checkpoint of the
   SAC-Lag state trained on the card restored bit for bit; the Q-critic
   ensemble's batched form timed against one chain per tower at 256 and
   4,096 rows; these trainers run their grad steps in chunk graphs
   (``update_chunk`` 32), so their second iteration's update includes the
   capture;
6. CUDA graphs (``phase_graphs``, ``[graph ...]``): the trainers'
   dispatch settings replayed from CUDA graphs
   (``fsrl_torch/trainer/graphs.py``), each against the eager cycle of a
   trainer built alike from the same seed, bit for bit (else within
   tests/test_fuse_iters.py's rtol 2e-4 / atol 2e-5, printed as a
   finding): PPO-Lag bf16 and f32 at 4096 envs x 64 steps with
   ``fuse_iters`` 8 (``bench.py:114``: 8 K1 and 256 K2 a dispatch),
   f32 at hidden (256, 256), TRPO-Lag (DroneRun), CPO (AntRun) and
   recurrent PPO-Lag (PointGoal1) with ``fuse_iters`` 2, PPO-Lag bf16
   with ``rollout_unroll`` 8 (its rollout timed alone too), recurrent
   PPO-Lag with ``rollout_unroll`` 8 over 3 rollouts (the update's BPTT
   start is the carry the rollout's graphs were given); DDPG-Lag,
   SAC-Lag and CVPO at the off-policy shape with ``update_chunk`` 256 and
   ``fuse_iters`` 2 (JAX's benchmark fuses 8; cut for the script's
   time), and their chunk graphs; each path's mode, launches a dispatch
   against the eager cycle's, and ms an iteration (off-policy: a grad
   step) replayed and eager, with the card's name and power limit; every
   trainer the script builds prints its mode (``[mode]``);
7. data parallel (``phase_dp``): two ranks spawned by the script
   (``--dp-rank``), sharing the card over gloo and loading the kernels the
   parent built: ``[dp ppo_lag f32]`` and ``[dp ppo_lag bf16]``, PPO-Lag on
   SafetyCarCircle-v0 at 4096 envs x 64 steps global, repeat 4 x 8, one
   iteration from a fresh trainer at ``dp_blocks`` 2 and 1 and seeds 3, 4
   and 5 (the first case a second iteration), exactly 1 K1 and 32 K2 of
   the form on each rank every iteration, the ranks' parameters
   ``torch.equal`` after each, after the first within ``DP_TOL`` of one
   process with the same seed (f32 rtol 2e-4 / atol 2e-5, the CPU tests';
   bf16 atol 1.6e-3), and equal bit for bit to one process whose K2 runs
   on the rows of each minibatch that each rank owns, summed with the
   ranks' weights (``_shares``: the halves at ``dp_blocks`` 2, uneven
   shares at 1); beside them
   one process against itself with every gradient entry moved one ulp
   before each Adam step, two ranks with the policy on their own rows (not
   the path), a rank's collect both ways, and the policy's forward at a
   rank's share of the rows; ``[dp cpo]`` (AntRun, one iteration: the
   ranks equal, one ``optim_case``); ``[dp sac_lag]`` at the off-policy
   benchmark shape, one iteration of 640 grad steps, equal to one process
   bit for bit, buffers included (one process runs its grad steps in
   chunk graphs, the ranks eagerly);
8. command lines (``phase_cli``): ``python -m
   fsrl_torch.examples.mlp.train_ppol_agent`` for one epoch of one
   collect on the card, then ``eval_ppol_agent --path`` on its run
   directory; the same under ``torchrun --nproc_per_node 1`` with
   ``--use_mesh true`` (NCCL, one rank); then the training-quality entry
   points: ``[curves ppol]`` and ``[curves sacl]``, the learning-curve
   runner (``fsrl_torch.examples.run_curves``) for one epoch of
   SafetyCarCircle-v0 and two of SafetyBallCircle-v0, whose second epoch
   captures and replays the runner's graph of 10 off-policy cycles (its
   JSON keys those of the JAX runner's committed result, the summary
   table written, exactly 1 K1 and 16 K2 launches on ``ppol``, none on
   ``sacl``);
   ``[customized ...]``, the hand-assembled loops
   (``fsrl_torch.examples.customized``): ``train_ppol`` for 2 iterations
   (2 K1, 32 K2), then ``eval_ppol`` on its run directory, whose
   evaluation must equal the trained state's bit for bit, and
   ``collect_dataset`` for 2 epochs (2 K1), whose HDF5 file must read
   back with the dataset's keys, dtypes and shapes; ``[gates offpolicy]``,
   the constrained CVPO gate of ``tests/test_all_agents.py`` (too long for
   the CPU tests) at its budget, seed and thresholds, no kernel launched,
   on chunk graphs;
9. breakdown: for PPO-Lag and the three f32 trust-region / FOCOPS paths the
   two halves of an iteration and one iteration under ``torch.profiler``,
   then one SAC-Lag collect and the first 32 of its 640 grad steps under it
   (device busy share, device ops and host ms per grad step); then one
   replay of the fused bf16 PPO-Lag graph under it, whose device events
   must hold K1 and K2 as many times as its capture launched them (a
   replay runs no kernel wrapper, so the counters cannot show them);
   last, because the profiler leaves every later launch slower for the
   host;
10. summary: one JSON line of kernels (K1, K2 bf16, K2 f32, and K2's
   generic form in bf16 and f32; their launches by path, the
   data-parallel ranks' and the graphed paths' among them: a graphed
   path's launches are its capture's times one more than its replays,
   the eager warm-up included), the card's
   name and power limit, and the result line
   ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when CUDA is unavailable, when the
``fsrl_torch`` sources are not beside the script, or when any phase fails.
Kernel times are medians of 20 CUDA-event timings, each of 10 calls
replayed from a CUDA graph after warm-up, with the inputs resident in L2.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet), for the bound of each kernel.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
TF32_FLOP_PER_S = 495e12
F32_FLOP_PER_S = 67e12

# the full width of the on-policy paths: envs x steps per collect
N_ENVS, T_STEPS = 4096, 64


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, reps: int = 20, inner: int = 10) -> float:
    """Median device time of one call of ``fn``, in ms. The calls are
    captured ``inner`` at a time into a CUDA graph, so host overhead (the
    Python wrapper) is not timed."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _timed(fn):
    """``fn()`` and its host-clock time in ms, the device drained before
    and after."""
    import torch
    torch.cuda.synchronize()
    t = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.time() - t)


# what a block may use of an H100 SM's shared memory (opt-in maximum)
SMEM_LIMIT = 232448


def ptxas_report(log: str) -> dict:
    """ptxas' registers and spill bytes of each tuned K2 instance in a
    build's output: ``{(form, KD or WIDE, AM): (registers, spill stores,
    spill loads)}``, form "bf16" (template <KD, AM>) or "f32" (<WIDE,
    AM>)."""
    import re
    out = {}
    for name, v in ptxas_entries(log).items():
        k = (re.search(r"ppo_grad_bf16_kernelILi(\d+)ELi(\d+)E", name)
             or re.search(r"ppo_grad_f32_kernelILb(\d)ELi(\d+)E", name))
        if k:
            form = "bf16" if "bf16" in name else "f32"
            out[form, int(k.group(1)), int(k.group(2))] = v
    return out


def ptxas_entries(log: str) -> dict:
    """ptxas' registers and spill bytes of every entry function in a
    build's output: ``{name: (registers, spill stores, spill loads)}``."""
    import re
    out, name, spill = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = (int(m.group(1)), *spill)
            name, spill = None, (0, 0)
    return out


# every K2 launch counter: the tuned bf16 and f32 kernels and the generic
# form's two dtypes
K2_NAMES = ("fused_ppo_grad", "fused_ppo_grad_f32", "fused_ppo_grad_any",
            "fused_ppo_grad_any_f32")


def k2_only(launches: dict, form: str, n: int) -> bool:
    """Whether ``launches`` holds exactly ``n`` launches of the K2 counter
    ``form`` and none of the other K2 counters."""
    return all(launches.get(k, 0) == (n if k == form else 0)
               for k in K2_NAMES)


# The K2 instances the training paths launch, (form, KD or WIDE, AM): bf16
# at D 9 (KD 1) and D 17 / 21 (KD 2), A <= 4 and the host path's A 6, the
# sliced form (KD 0) at Ant's (105, 8) and Humanoid's (348, 17); f32 narrow
# and wide at A <= 4, and the wide-action instances for 8 and 32 actions
PATH_INSTANCES = {("bf16", 1, 4), ("bf16", 2, 4), ("bf16", 2, 8),
                  ("bf16", 0, 8), ("bf16", 0, 32),
                  ("f32", 0, 4), ("f32", 1, 4), ("f32", 1, 8),
                  ("f32", 1, 32)}
# K2's shared memory does not grow with D above 64 (the sliced form), so
# the envelope's widths are checked up to 80 and at the wide tasks' widths
SMEM_WIDTHS = (*range(1, 81), 105, 129, 348, 376, 1000)


def phase_build():
    from fsrl_torch.ops import fused_ppo_grad as fpg
    from fsrl_torch.ops import kernels
    t0 = time.time()
    so = kernels.build(verbose=True)
    lib = kernels.library()
    print(f"[build] {so.name} in {time.time() - t0:.1f} s", flush=True)
    # K2's dynamic shared memory at the main paths' shapes and the
    # envelope's corners, then its largest over the whole envelope
    for D, A, K in ((9, 2, 2), (12, 4, 6), (16, 4, 6), (21, 2, 2),
                    (54, 2, 2), (64, 4, 6), (17, 6, 2), (9, 8, 6),
                    (12, 8, 6), (16, 8, 6), (64, 8, 6), (105, 8, 2),
                    (105, 8, 6), (348, 17, 2), (348, 17, 6), (376, 24, 2),
                    (9, 9, 2), (1, 32, 6), (348, 32, 6)):
        b, f = (lib.fsrl_ppo_grad_smem_bytes(D, A, K, bf16)
                for bf16 in (1, 0))
        print(f"[build] K2 shared memory at D {D}, A {A}, K {K}: bf16 {b} "
              f"bytes, f32 {f} bytes (limit {SMEM_LIMIT})", flush=True)
    most = max((lib.fsrl_ppo_grad_smem_bytes(D, A, K, bf16), bf16, D, A, K)
               for D in SMEM_WIDTHS
               for A in range(1, fpg.KERNEL_A_MAX + 1)
               for K in range(1, fpg.KERNEL_M_MAX + 2) for bf16 in (0, 1))
    print(f"[build] K2 shared memory, most over the envelope (any D, A <= "
          f"{fpg.KERNEL_A_MAX}, K <= {fpg.KERNEL_M_MAX + 1}): {most[0]} "
          f"bytes ({'bf16' if most[1] else 'f32'} at D {most[2]}, A "
          f"{most[3]}, K {most[4]})", flush=True)
    if most[0] > SMEM_LIMIT:
        fail(f"K2 needs more shared memory than a block has at {most[2:]}")
    # ptxas' registers and spills of each K2 instance
    report = {}
    for src in ("fused_ppo_grad.cu", "fused_ppo_grad_f32.cu"):
        report.update(ptxas_report(kernels.BUILD_LOG.get(src, "")))
    for key in sorted(report):
        regs, st, ld = report[key]
        form, kd, am = key
        what = f"KD {kd}" if form == "bf16" else ("wide" if kd else "narrow")
        print(f"[build] K2 {form} {what} A <= {am}: {regs} registers, "
              f"spill stores {st} bytes, loads {ld} bytes"
              f"{' (on a training path)' if key in PATH_INSTANCES else ''}",
              flush=True)
    # the generic form (csrc/fused_ppo_grad_any.cu): every kernel's
    # registers and spills, its static shared memory (the same at every
    # shape) and its scratch at the largest case the script runs
    for name, (regs, st, ld) in sorted(ptxas_entries(
            kernels.BUILD_LOG.get("fused_ppo_grad_any.cu", "")).items()):
        print(f"[build] K2 any {name}: {regs} registers, spill stores {st} "
              f"bytes, loads {ld} bytes", flush=True)
    # the generic form's shared memory: static, and the row block's h2
    # (64 x H2 floats, dynamic) where it fits, device memory above
    any_smem = {H2: lib.fsrl_ppo_grad_any_smem_bytes(H2)
                for H2 in (16, 64, 128, 256, 512, 744, 768, 1024)}
    print(f"[build] K2 any shared memory by H2: {any_smem} bytes (limit "
          f"{SMEM_LIMIT})", flush=True)
    if not all(0 < b <= SMEM_LIMIT for b in any_smem.values()):
        fail(f"K2 any: shared memory {any_smem}")
    for dims in ((32768, 9, 256, 256, 2, 2), (32768, 9, 64, 64, 2, 2),
                 (256, 348, 128, 128, 40, 2), (4096, 105, 512, 512, 8, 2),
                 (32768, 348, 128, 128, 40, 2)):
        n = lib.fsrl_ppo_grad_any_scratch_floats(*dims)
        blocks, slices = ([fn(*dims, bf16) for bf16 in (1, 0)] for fn in (
            lib.fsrl_ppo_grad_any_row_blocks, lib.fsrl_ppo_grad_any_splits))
        print(f"[build] K2 any at (B, D, H1, H2, A, K) = {dims}: scratch "
              f"{4 * n} bytes; row kernel {blocks[0]} / {blocks[1]} blocks "
              f"a tower, weight-gradient products in {slices[0]} / "
              f"{slices[1]} row slices (bf16 / f32)", flush=True)
    any_spills = [name for name, (_, st, ld) in ptxas_entries(
        kernels.BUILD_LOG.get("fused_ppo_grad_any.cu", "")).items()
        if st or ld]
    if any_spills:
        fail(f"K2 any: kernels spill: {any_spills}")
    if not PATH_INSTANCES <= set(report):
        fail(f"ptxas reported no K2 instance {PATH_INSTANCES - set(report)}"
             f" (a library built without its .log.json: delete "
             f"fsrl_torch/_build)")
    spilled = [k for k in PATH_INSTANCES if k in report and any(report[k][1:])]
    if spilled:
        fail(f"K2 instances on a training path spill: {spilled}")
    return report


def k2_instance(D: int, A: int, bf16: bool) -> tuple:
    """The K2 instance (form, KD or WIDE, AM) that the library launches at
    (D, A), as ``ptxas_report`` names it (the dispatch of
    ``fsrl_ppo_grad`` and ``launch_f32``)."""
    if bf16:
        if D > 64 or A > 8:                    # the sliced form, KD 0
            return ("bf16", 0, 32 if A > 8 else 8)
        return ("bf16", -(-D // 16), 8 if A > 4 else 4)
    return ("f32", int(A > 4 or D > 12), 32 if A > 8 else 8 if A > 4 else 4)


def phase_train():
    import torch
    from fsrl_torch.agent import PPOLagAgent
    from fsrl_torch.ops import kernels

    N, T, iters = 4096, 64, 3
    agent = PPOLagAgent("SafetyCarCircle-v0", cost_limit=10.0, repeat=4,
                        n_minibatches=8, compute_dtype=torch.bfloat16)
    if not agent.algo.use_grad_kernel:
        fail("the benchmark config is outside the fused grad kernel's "
             "envelope")
    kernels.reset_launch_counts()
    t0 = time.time()
    info = agent.learn(epochs=1, step_per_epoch=iters * N * T, n_envs=N,
                       steps_per_collect=T, episode_per_test=10)
    torch.cuda.synchronize()
    learn_s = time.time() - t0
    launches = dict(kernels.LAUNCHES)
    metrics = agent.trainer.last_metrics
    print(f"[train] learn(3 iterations + test) {learn_s:.2f} s; info {info}",
          flush=True)
    print(f"[train] last metrics {metrics}", flush=True)
    print(f"[train] launches {launches}", flush=True)
    if not metrics or not all(math.isfinite(v) for v in metrics.values()):
        fail(f"non-finite or missing losses: {metrics}")
    if launches.get("gae", 0) < iters:
        fail(f"GAE kernel launched {launches.get('gae', 0)} < {iters} times")
    if launches.get("fused_ppo_grad", 0) < iters * 32 or any(
            launches.get(k, 0) for k in K2_NAMES[1:]):
        fail(f"grad kernel launched {launches.get('fused_ppo_grad', 0)} < "
             f"{iters * 32} times")

    # steady-state iteration time, outside the counted run
    tr = agent.trainer
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.time()
        tr._run_iter()
        torch.cuda.synchronize()
        times.append(time.time() - t)
    ms = 1e3 * statistics.median(times)
    print(f"[train] iteration {ms:.2f} ms (median of 3: "
          f"{[round(1e3 * x, 2) for x in times]}), "
          f"{N * T / (ms / 1e3):.0f} env-steps/s", flush=True)
    return launches, tr


def _timed_iterations(agent, n: int = 3):
    """``n`` iterations of a trained agent, each collect and update timed
    apart on the host clock (device drained before and after). Returns the
    collect and update ms and each iteration's rollout, metrics and
    accepted line-search indices (TRPO-Lag keeps them out of its
    metrics)."""
    tr = agent.trainer
    collect, update, steps = [], [], []
    for _ in range(n):
        res, c_ms = _timed(lambda: tr.rollout(
            tr.state.params, tr.env_state, tr.stats.reset_aggregates(),
            tr.generator, hidden=tr.hidden))
        # a recurrent update takes the carry at the segment's start
        carry = (res.init_hidden,) if tr.recurrent else ()
        (tr.state, m), u_ms = _timed(lambda: agent.algo.update(
            tr.state, res.transitions, *carry, res.stats.mean_cost,
            res.stats.n_episodes, tr.generator))
        tr.env_state, tr.stats, tr.hidden = (res.env_state, res.stats,
                                             res.hidden)
        collect.append(c_ms)
        update.append(u_ms)
        steps.append((res, m, getattr(agent.algo, "last_backtracks", None)))
    return collect, update, steps


def phase_train_ppo_f32():
    """f32 PPO-Lag (the config's default dtype) at the benchmark width
    through the agent API: one iteration plus the test with the launch
    counters read around it (32 launches of the f32 K2 kernel, the
    TF32-split tensor-core kernel), then 3 iterations with collect and
    update timed apart and their launches counted."""
    from fsrl_torch.agent import PPOLagAgent
    from fsrl_torch.ops import kernels

    N, T = N_ENVS, T_STEPS
    agent = PPOLagAgent("SafetyCarCircle-v0", cost_limit=10.0, repeat=4,
                        n_minibatches=8)
    if not agent.algo.use_grad_kernel:
        fail("the f32 PPO-Lag config is outside the grad kernel's envelope")
    kernels.reset_launch_counts()
    info, ms = _timed(lambda: agent.learn(
        epochs=1, step_per_epoch=N * T, n_envs=N, steps_per_collect=T,
        episode_per_test=2))
    launches = dict(kernels.LAUNCHES)
    metrics = agent.trainer.last_metrics
    print(f"[train ppo_lag f32] learn(1 iteration + test) {ms / 1e3:.2f} s; "
          f"launches {launches}", flush=True)
    if not metrics or not all(math.isfinite(v) for v in metrics.values()):
        fail(f"ppo_lag f32: non-finite or missing losses: {metrics}")
    if not k2_only(launches, "fused_ppo_grad_f32", 32):
        fail(f"ppo_lag f32: expected 32 launches of the f32 grad kernel "
             f"and none of the bf16 one, got {launches}")
    kernels.reset_launch_counts()
    collect, update, steps = _timed_iterations(agent)
    timed = dict(kernels.LAUNCHES)
    c_ms, u_ms = statistics.median(collect), statistics.median(update)
    print(f"[train ppo_lag f32] iteration {c_ms + u_ms:.2f} ms = collect "
          f"{c_ms:.2f} + update {u_ms:.2f} (medians of 3; updates "
          f"{[round(u, 2) for u in update]}), "
          f"{N * T / ((c_ms + u_ms) / 1e3):.0f} env-steps/s; launches in "
          f"the 3 iterations {timed}", flush=True)
    if not k2_only(timed, "fused_ppo_grad_f32", 96) or not all(
            math.isfinite(float(v)) for _, m, _ in steps for v in m.values()):
        fail(f"ppo_lag f32: the timed iterations launched {timed}")
    return launches["fused_ppo_grad_f32"]


# the navigation path: observation 21, inside K2's widened envelope only
NAV_TASK = "SafetyPointGoal1-v0"


def phase_train_nav():
    """PPO-Lag on the navigation task at full width (repeat 4 x 8), f32 and
    bf16: one iteration plus the test with the launch counters zeroed
    before and read after (exactly 1 K1 and 32 K2 of the matching form;
    0 K2 would be the autograd fallback), then 3 iterations with collect
    and update timed apart. Returns the launch counts by path."""
    import torch
    from fsrl_torch.agent import PPOLagAgent
    from fsrl_torch.ops import kernels

    N, T = N_ENVS, T_STEPS
    counts = {}
    for dtype in (None, torch.bfloat16):
        form = "fused_ppo_grad" if dtype else "fused_ppo_grad_f32"
        tag = f"train ppo_lag nav {'bf16' if dtype else 'f32'}"
        agent = PPOLagAgent(NAV_TASK, cost_limit=25.0, repeat=4,
                            n_minibatches=8, compute_dtype=dtype)
        layout = agent.algo.grad_layout
        if not agent.algo.use_grad_kernel or layout.D != 21:
            fail(f"[{tag}] {layout} is not on the grad kernel's path")
        kernels.reset_launch_counts()
        info, ms = _timed(lambda: agent.learn(
            epochs=1, step_per_epoch=N * T, n_envs=N, steps_per_collect=T,
            episode_per_test=2))
        launches = dict(kernels.LAUNCHES)
        metrics = agent.trainer.last_metrics
        print(f"[{tag}] {NAV_TASK} (D {layout.D}): learn(1 iteration + "
              f"test) {ms / 1e3:.2f} s; launches {launches}; info {info}",
              flush=True)
        if not metrics or not all(math.isfinite(v) for v in metrics.values()):
            fail(f"[{tag}] non-finite or missing losses: {metrics}")
        if launches.get("gae", 0) != 1 or not k2_only(launches, form, 32):
            fail(f"[{tag}] expected 1 launch of K1 and 32 of {form} (no "
                 f"other K2 form), got {launches}")
        counts[tag] = launches
        kernels.reset_launch_counts()
        collect, update, steps = _timed_iterations(agent)
        timed = dict(kernels.LAUNCHES)
        c_ms, u_ms = statistics.median(collect), statistics.median(update)
        print(f"[{tag}] iteration {c_ms + u_ms:.2f} ms = collect "
              f"{c_ms:.2f} + update {u_ms:.2f} (medians of 3; collects "
              f"{[round(c, 2) for c in collect]}, updates "
              f"{[round(u, 2) for u in update]}), "
              f"{N * T / ((c_ms + u_ms) / 1e3):.0f} env-steps/s; launches "
              f"in the 3 iterations {timed}", flush=True)
        if timed.get(form, 0) != 96 or not all(
                math.isfinite(float(v)) for _, m, _ in steps
                for v in m.values()):
            fail(f"[{tag}] the timed iterations launched {timed}")
    return counts


def phase_train_rnn():
    """Recurrent PPO-Lag (GRU 128, critics (128, 128)) on the navigation
    task at 4096 envs x 64 steps: one iteration plus the (recurrent) test
    with the launch counters read around it (1 K1, no K2: the GRU's BPTT
    is autograd), then 3 iterations with collect and update timed apart.
    Returns the launch counts."""
    from fsrl_torch.agent import RecurrentPPOLagAgent
    from fsrl_torch.ops import kernels

    N, T = N_ENVS, T_STEPS
    tag = "train ppo_lag_rnn"
    agent = RecurrentPPOLagAgent(NAV_TASK, cost_limit=25.0, hidden_size=128,
                                 critic_hidden_sizes=(128, 128))
    kernels.reset_launch_counts()
    info, ms = _timed(lambda: agent.learn(
        epochs=1, step_per_epoch=N * T, n_envs=N, steps_per_collect=T,
        episode_per_test=2))
    launches = dict(kernels.LAUNCHES)
    metrics = agent.trainer.last_metrics
    print(f"[{tag}] {NAV_TASK}, {N} envs x {T} steps: learn(1 iteration + "
          f"test) {ms / 1e3:.2f} s; launches {launches}; info {info}",
          flush=True)
    print(f"[{tag}] last metrics {metrics}", flush=True)
    if not metrics or not all(math.isfinite(v) for v in metrics.values()):
        fail(f"[{tag}] non-finite or missing losses: {metrics}")
    if launches.get("gae", 0) != 1 or any(launches.get(k, 0)
                                          for k in K2_NAMES):
        fail(f"[{tag}] expected 1 launch of K1 and none of K2, got "
             f"{launches}")
    kernels.reset_launch_counts()
    collect, update, steps = _timed_iterations(agent)
    timed = dict(kernels.LAUNCHES)
    c_ms, u_ms = statistics.median(collect), statistics.median(update)
    print(f"[{tag}] iteration {c_ms + u_ms:.2f} ms = collect {c_ms:.2f} + "
          f"update {u_ms:.2f} (medians of 3; updates "
          f"{[round(u, 2) for u in update]}), "
          f"{N * T / ((c_ms + u_ms) / 1e3):.0f} env-steps/s; launches in "
          f"the 3 iterations {timed}", flush=True)
    if timed.get("gae", 0) != 3 or not all(
            math.isfinite(float(v)) for _, m, _ in steps for v in m.values()):
        fail(f"[{tag}] the timed iterations launched {timed}")
    return launches


def phase_train_width(hidden, dtypes=(None, "bf16")):
    """PPO-Lag on SafetyCarCircle-v0 at the benchmark shape (4096 envs x 64
    steps, repeat 4 x 8 minibatches of 32,768 rows) at hidden ``hidden``,
    where K2 takes its generic form: ``learn`` for 3 iterations plus the
    test with the launch counters zeroed before and read after (exactly 3
    K1 and 96 launches of the generic form of the dtype, none of any other
    K2 form: 0 would be the autograd step), then 3 iterations with collect
    and update timed apart. Returns the launch counts and timings by tag."""
    import torch
    from fsrl_torch.agent import PPOLagAgent
    from fsrl_torch.ops import kernels
    from fsrl_torch.ops.fused_ppo_grad import kernel_form, launch_name

    N, T, iters = N_ENVS, T_STEPS, 3
    out = {}
    for dtype in dtypes:
        tdt = torch.bfloat16 if dtype else None
        widths = "x".join(map(str, hidden[:1] if len(set(hidden)) == 1
                              else hidden))
        tag = f"train ppo_lag h{widths} {'bf16' if dtype else 'f32'}"
        agent = PPOLagAgent("SafetyCarCircle-v0", cost_limit=10.0, repeat=4,
                            n_minibatches=8, compute_dtype=tdt,
                            hidden_sizes=hidden)
        layout = agent.algo.grad_layout
        if not agent.algo.use_grad_kernel or kernel_form(layout) != "any":
            fail(f"[{tag}] {layout} is not on the generic K2 form's path")
        form = launch_name(layout, tdt is not None)
        kernels.reset_launch_counts()
        info, ms = _timed(lambda: agent.learn(
            epochs=1, step_per_epoch=iters * N * T, n_envs=N,
            steps_per_collect=T, episode_per_test=10))
        launches = dict(kernels.LAUNCHES)
        metrics = agent.trainer.last_metrics
        print(f"[{tag}] SafetyCarCircle-v0, hidden {hidden}, {N} envs x {T} "
              f"steps: learn({iters} iterations + test) {ms / 1e3:.2f} s; "
              f"launches {launches}; info {info}", flush=True)
        print(f"[{tag}] last metrics {metrics}", flush=True)
        if not metrics or not all(math.isfinite(v) for v in metrics.values()):
            fail(f"[{tag}] non-finite or missing losses: {metrics}")
        if not all(math.isfinite(float(info[k])) for k in
                   ("test_reward", "test_cost")):
            fail(f"[{tag}] non-finite test result {info}")
        if launches.get("gae", 0) != iters or not k2_only(launches, form,
                                                          32 * iters):
            fail(f"[{tag}] expected {iters} launches of K1 and {32 * iters} "
                 f"of {form} (no other K2 form), got {launches}")
        kernels.reset_launch_counts()
        collect, update, steps = _timed_iterations(agent)
        timed = dict(kernels.LAUNCHES)
        c_ms, u_ms = statistics.median(collect), statistics.median(update)
        print(f"[{tag}] iteration {c_ms + u_ms:.2f} ms = collect "
              f"{c_ms:.2f} + update {u_ms:.2f} (medians of 3; collects "
              f"{[round(c, 2) for c in collect]}, updates "
              f"{[round(u, 2) for u in update]}), "
              f"{N * T / ((c_ms + u_ms) / 1e3):.0f} env-steps/s; launches "
              f"in the 3 iterations {timed}", flush=True)
        if not k2_only(timed, form, 96) or not all(
                math.isfinite(float(v)) for _, m, _ in steps
                for v in m.values()):
            fail(f"[{tag}] the timed iterations launched {timed}")
        out[tag] = dict(launches=launches, collect_ms=c_ms, update_ms=u_ms)
    return out


# The host path at the JAX package's velocity protocol
# (benchmarks/run_velocity.py:28-46, 64-110): 10 host envs x 2000 steps a
# collect, episodes of 1000 steps, PPO-Lag with repeat 4 x (20000 // 256 =
# 78) minibatches of 256 rows; SAC-Lag on 4 envs x 100 steps, 0.2 grad steps
# an env step, buffer 100,000.
HOST_TASK = "SafetyHalfCheetahVelocity-v1"
HOST_ENVS, HOST_T, HOST_EP = 10, 2000, 1000
HOST_OFF_ENVS, HOST_OFF_T = 4, 100


# The velocity tasks the stand-in takes: (observation, action, index of
# the x velocity in the observation, |s_0| bound past which an episode
# terminates or None, healthy reward a step), from the gymnasium env's
# widths and observation layout (x velocity after the positions that
# exclude x and y) and its termination (Ant and Humanoid fall; HalfCheetah
# never terminates). "<task>:a40" is Humanoid's stand-in with 40 actions:
# no task of the repo has more than 17, and this width is what drives K2's
# generic form above 32 actions on the host path
STAND_IN = {"SafetyHalfCheetahVelocity-v1": (17, 6, 8, None, 0.0),
            "SafetyAntVelocity-v1": (105, 8, 13, 3.0, 1.0),
            "SafetyHumanoidVelocity-v1": (348, 17, 22, 5.0, 5.0),
            "SafetyHumanoidVelocity-v1:a40": (348, 40, 22, 5.0, 5.0)}
HOST_A40 = "SafetyHumanoidVelocity-v1:a40"
# terminated episodes of each task's stand-in envs, over the process
TERMINATED = dict.fromkeys(STAND_IN, 0)


class StandInVelocity:
    """A numpy stand-in for a Safety-Gymnasium velocity task (HalfCheetah-v5,
    Ant-v5 or Humanoid-v5 under the velocity cost), for a machine without
    gymnasium and mujoco: the task's widths (actions in [-1, 1]),
    truncation at 1000 steps and the cost 1[|x velocity| > limit] at the
    limit of ``fsrl_torch/envs/velocity.py``. The dynamics are a damped
    linear system driven by the action, with its own seeded noise (the
    coupling scaled by sqrt(17 / D), so that HalfCheetah's is the one its
    earlier readings were taken on, and every width's is stable); the x velocity sits at the task's index, and
    the reward is that velocity minus 0.1 |a|^2 plus the healthy reward.
    Ant's and Humanoid's episodes terminate once |s_0| (the stand-in's
    torso height) passes a bound."""

    def __init__(self, task: str = "SafetyHalfCheetahVelocity-v1",
                 seed: int = 0):
        import numpy as np
        from types import SimpleNamespace
        from fsrl_torch.envs.velocity import VELOCITY_LIMITS
        self.np = np
        self.task = task
        D, A, self.vx, self.bound, self.healthy = STAND_IN[task]
        self.limit = VELOCITY_LIMITS[task.split(":")[0]][1]
        g = np.random.default_rng(1000 + seed)
        self.A = 0.9 * np.eye(D) + 0.01 * math.sqrt(17 / D) * g.normal(
            size=(D, D))
        self.B = 0.5 * g.normal(size=(D, A))
        self.rng = np.random.default_rng(seed)
        self.observation_space = SimpleNamespace(shape=(D,))
        self.action_space = SimpleNamespace(
            shape=(A,), low=-np.ones(A, np.float32),
            high=np.ones(A, np.float32))
        self.spec = SimpleNamespace(max_episode_steps=HOST_EP)
        self.s, self.t = np.zeros(D), 0

    def reset(self, seed=None, options=None):
        if seed is not None:
            self.rng = self.np.random.default_rng(seed)
        self.s = 0.1 * self.rng.normal(size=self.s.shape[0])
        self.t = 0
        return self.s.copy(), {}

    def step(self, action):
        np = self.np
        a = np.clip(np.asarray(action, np.float64), -1.0, 1.0)
        self.s = self.A @ self.s + self.B @ a + 0.05 * self.rng.normal(
            size=self.s.shape[0])
        self.t += 1
        vx = float(self.s[self.vx])
        info = {"cost": float(abs(vx) > self.limit), "x_velocity": vx}
        term = self.bound is not None and abs(self.s[0]) > self.bound
        TERMINATED[self.task] += term
        return (self.s.copy(), vx - 0.1 * float(a @ a) + self.healthy,
                bool(term), self.t >= HOST_EP and not term, info)

    def close(self):
        pass


def _standin_venv(n, task: str = HOST_TASK):
    from fsrl_torch.envs.host_env import HostVectorEnv
    return HostVectorEnv([lambda i=i: StandInVelocity(task, i)
                          for i in range(n)])


def _host_iterations(tr, n: int = 3):
    """``n`` collect + update iterations of a host trainer, each half timed
    on the host clock (device drained before and after); the collect split
    into env, policy and transfer. Returns the medians, in ms."""
    import torch
    rows = []
    for _ in range(n):
        seg, c_ms = _timed(tr.collect_segment)
        split = dict(tr.collect_split)
        if not seg[0].obs.is_cuda or not seg[1].is_cuda:
            fail("the host trainer's segment is not on the card")
        if hasattr(tr, "update_block"):
            tr.buf_state = tr.buffer.add_segment(tr.buf_state, seg[0])

            def upd():
                tr.last_metrics = tr.update_block(seg[1], seg[2])
        else:
            def upd():
                tr.state, tr.last_metrics = tr.algo.update(
                    tr.state, *seg, tr.generator)
        _, u_ms = _timed(upd)
        tr._host_params = None
        rows.append((c_ms, 1e3 * split["env"], 1e3 * split["act"],
                     1e3 * split["transfer"], u_ms))
        if not all(math.isfinite(float(v))
                   for v in tr.last_metrics.values()):
            fail(f"non-finite metrics {tr.last_metrics}")
    med = [statistics.median(c) for c in zip(*rows)]
    torch.cuda.synchronize()
    return dict(zip(("collect", "env", "act", "transfer", "update"), med))


def phase_train_host(make_venv=None, label="stand-in", iters=1,
                     task=HOST_TASK, name="", tag_name=None):
    """PPO-Lag through ``HostOnpolicyTrainer`` at the velocity protocol on
    ``task``'s widths, f32 and bf16: one epoch (one collect and update, and
    the episode-exact test) with the launch counters zeroed before and
    read after (exactly 1 K1 and 312 K2 of the form the widths take, at
    256 rows, and none of the others), then ``iters`` iterations timed.
    ``make_venv(n)`` defaults to the task's stand-in; ``name`` goes into
    the phase's tag ("train host ppo_lag <name> f32"), or ``tag_name``
    replaces "ppo_lag <name>". Returns the launch counts and timings."""
    import torch
    from fsrl_torch.algos.ppo_lag import PPOLag
    from fsrl_torch.ops import kernels
    from fsrl_torch.ops.fused_ppo_grad import launch_name
    from fsrl_torch.trainer.host_trainer import HostOnpolicyTrainer

    out = {}
    n_mb = HOST_ENVS * HOST_T // 256
    widths = STAND_IN[task][:2]
    for dtype in (None, torch.bfloat16):
        what = tag_name or f"ppo_lag{' ' + name if name else ''}"
        tag = f"train host {what} {'bf16' if dtype else 'f32'}"
        venv = (make_venv or (lambda n: _standin_venv(n, task)))(HOST_ENVS)
        algo = PPOLag(venv.observation_size, venv.action_size,
                      cost_limit=25.0, lagrangian_pid=(0.05, 0.0005, 0.1),
                      repeat=4, n_minibatches=n_mb, episode_len=HOST_EP,
                      compute_dtype=dtype)
        layout = algo.grad_layout
        if not algo.use_grad_kernel or (layout.D, layout.A) != widths:
            fail(f"[{tag}] {layout} is not on the grad kernel's path")
        form = launch_name(layout, dtype is not None)
        tr = HostOnpolicyTrainer(algo, venv, epochs=1,
                                 step_per_epoch=HOST_ENVS * HOST_T,
                                 steps_per_collect=HOST_T,
                                 episode_per_test=HOST_ENVS, cost_limit=25.0,
                                 seed=0, verbose=False)
        kernels.reset_launch_counts()
        term0 = TERMINATED.get(task, 0)
        (_, _, info), ms = _timed(lambda: next(tr))
        launches = dict(kernels.LAUNCHES)
        if task in TERMINATED and make_venv is None:
            print(f"[{tag}] terminated episodes in the epoch: "
                  f"{TERMINATED[task] - term0}", flush=True)
        print(f"[{tag}] {task} ({label}), {HOST_ENVS} envs x {HOST_T} "
              f"steps, repeat 4 x {n_mb} minibatches of "
              f"{HOST_ENVS * HOST_T // n_mb} rows, D {layout.D}, A "
              f"{layout.A}: epoch (1 collect + update + test of "
              f"{HOST_ENVS} episodes) {ms / 1e3:.2f} s; launches "
              f"{launches}; info {info}", flush=True)
        if not tr.state.flat.is_cuda:
            fail(f"[{tag}] the update's state is not on the card")
        if launches.get("gae", 0) != 1 or not k2_only(launches, form,
                                                      4 * n_mb):
            fail(f"[{tag}] expected 1 launch of K1 and {4 * n_mb} of {form} "
                 f"(no other K2 form), got {launches}")
        if not all(math.isfinite(float(info[k])) for k in
                   ("test_reward", "test_cost")):
            fail(f"[{tag}] non-finite test result {info}")
        t = {}
        if iters:
            t = _host_iterations(tr, iters)
            print(f"[{tag}] iteration {t['collect'] + t['update']:.2f} ms = "
                  f"collect {t['collect']:.2f} (env {t['env']:.2f}, policy "
                  f"{t['act']:.2f}, transfer {t['transfer']:.2f}) + update "
                  f"{t['update']:.2f} (medians of {iters}), "
                  f"{HOST_ENVS * HOST_T / ((t['collect'] + t['update']) / 1e3):.0f}"
                  f" env-steps/s", flush=True)
        venv.close()
        out[tag] = dict(launches=launches, epoch_ms=ms, **t)
    return out


def phase_train_host_cli():
    """The host velocity command line's ``run``
    (``fsrl_torch/examples/mlp/train_velocity_host.py``) for one epoch at
    its defaults (10 envs x 500 steps a collect, PPO-Lag's repeat 4 x 4
    minibatches, f32) but an epoch of one collect (the default is 4), on
    Humanoid's widths over the stand-in, with a ``DummyLogger`` (the card's
    machine has no tensorboardX): the launch counters zeroed before and
    read after, exactly 1 K1 and 16 f32 K2 launches a collect."""
    from fsrl_torch.examples.mlp.train_velocity_host import VelCfg, run
    from fsrl_torch.ops import kernels
    from fsrl_torch.utils.logger import DummyLogger

    task = "SafetyHumanoidVelocity-v1"
    cfg = VelCfg(task=task, epochs=1)
    cfg.step_per_epoch = cfg.n_envs * cfg.steps_per_collect
    n_iter = cfg.step_per_epoch // (cfg.n_envs * cfg.steps_per_collect)
    kernels.reset_launch_counts()
    info, ms = _timed(lambda: run(
        cfg, make_venv=lambda n: _standin_venv(n, task),
        logger=DummyLogger()))
    launches = dict(kernels.LAUNCHES)
    print(f"[train host cli] {task} (stand-in), {cfg.n_envs} envs x "
          f"{cfg.steps_per_collect} steps, {n_iter} collects: epoch "
          f"{ms / 1e3:.2f} s; launches {launches}; info {info}", flush=True)
    if (launches.get("gae", 0), launches.get("fused_ppo_grad_f32", 0),
            launches.get("fused_ppo_grad", 0)) != (n_iter, 16 * n_iter, 0):
        fail(f"[train host cli] expected {n_iter} launches of K1 and "
             f"{16 * n_iter} of fused_ppo_grad_f32, got {launches}")
    if info.get("epoch") != 1 or not all(
            math.isfinite(float(info[k])) for k in ("test_reward",
                                                    "test_cost")):
        fail(f"[train host cli] bad result {info}")
    return dict(launches=launches, epoch_ms=ms)


def phase_train_host_sac(make_venv=_standin_venv, label="stand-in",
                         iters=3):
    """SAC-Lag through ``HostOffpolicyTrainer`` at the velocity protocol's
    off-policy shape: one epoch with the counters zeroed before and read
    after (no kernel on this path; 80 grad steps), then ``iters``
    iterations timed, and the ms per grad step."""
    from fsrl_torch.algos.sac_lag import SACLag
    from fsrl_torch.ops import kernels
    from fsrl_torch.trainer.host_trainer import HostOffpolicyTrainer

    tag = "train host sac_lag"
    venv = make_venv(HOST_OFF_ENVS)
    algo = SACLag(venv.observation_size, venv.action_size, cost_limit=25.0)
    tr = HostOffpolicyTrainer(algo, venv, epochs=1,
                              step_per_epoch=HOST_OFF_ENVS * HOST_OFF_T,
                              steps_per_collect=HOST_OFF_T,
                              buffer_size=100000, update_per_step=0.2,
                              episode_per_test=HOST_OFF_ENVS, cost_limit=25.0,
                              seed=0, verbose=False)
    kernels.reset_launch_counts()
    (_, _, info), ms = _timed(lambda: next(tr))
    launches = dict(kernels.LAUNCHES)
    n_upd = tr.n_updates
    print(f"[{tag}] {HOST_TASK} ({label}), {HOST_OFF_ENVS} envs x "
          f"{HOST_OFF_T} steps, {n_upd} grad steps a collect, batch "
          f"{algo.hp['batch_size']}, buffer {tr.buffer.C} x {tr.buffer.N}: "
          f"epoch {ms / 1e3:.2f} s; launches {launches}; info {info}",
          flush=True)
    if n_upd != 80 or int(tr.state.gradient_steps) != n_upd:
        fail(f"[{tag}] {int(tr.state.gradient_steps)} grad steps, "
             f"n_updates {n_upd}")
    if sum(launches.values()):
        fail(f"[{tag}] a PPO kernel launched on an off-policy path")
    t = _host_iterations(tr, iters)
    print(f"[{tag}] iteration {t['collect'] + t['update']:.2f} ms = collect "
          f"{t['collect']:.2f} (env {t['env']:.2f}, policy {t['act']:.2f}, "
          f"transfer {t['transfer']:.2f}) + update {t['update']:.2f} "
          f"({t['update'] / n_upd:.3f} ms per grad step; medians of "
          f"{iters})", flush=True)
    venv.close()
    return dict(launches=launches, grad_step_ms=t["update"] / n_upd, **t)


def phase_host_real():
    """The host path on the real tasks where gymnasium and mujoco import:
    one epoch and one timed iteration of PPO-Lag (f32 and bf16) and SAC-Lag
    on SafetyHalfCheetahVelocity-v1, and one PointGoal1 (raw MuJoCo) epoch
    of PPO-Lag. Where they do not, one line says so."""
    try:
        import gymnasium  # noqa: F401
        import mujoco  # noqa: F401
    except ImportError as e:
        print(f"[train host real] not run: gymnasium and mujoco do not "
              f"import here ({e}); the stand-in env took their place",
              flush=True)
        return None
    import torch
    from fsrl_torch.algos.ppo_lag import PPOLag
    from fsrl_torch.envs.pointgoal_mj import make_pointgoal_vector_env
    from fsrl_torch.envs.velocity import make_velocity_vector_env
    from fsrl_torch.ops import kernels
    from fsrl_torch.trainer.host_trainer import HostOnpolicyTrainer

    real = lambda n: make_velocity_vector_env(HOST_TASK, n)
    out = phase_train_host(real, "gymnasium HalfCheetah-v5", iters=1)
    out["sac_lag"] = phase_train_host_sac(real, "gymnasium HalfCheetah-v5",
                                          iters=1)
    venv = make_pointgoal_vector_env(HOST_ENVS)
    algo = PPOLag(venv.observation_size, venv.action_size, cost_limit=25.0,
                  repeat=4, n_minibatches=HOST_ENVS * HOST_T // 256,
                  episode_len=HOST_EP)
    tr = HostOnpolicyTrainer(algo, venv, epochs=1,
                             step_per_epoch=HOST_ENVS * HOST_T,
                             steps_per_collect=HOST_T, episode_per_test=2,
                             cost_limit=25.0, seed=0, verbose=False)
    kernels.reset_launch_counts()
    (_, _, info), ms = _timed(lambda: next(tr))
    launches = dict(kernels.LAUNCHES)
    torch.cuda.synchronize()
    print(f"[train host ppo_lag pointgoal_mj] SafetyPointGoal1 (raw MuJoCo, "
          f"D {algo.obs_dim}), {HOST_ENVS} envs x {HOST_T} steps: epoch "
          f"{ms / 1e3:.2f} s; launches {launches}; info {info}", flush=True)
    if (launches.get("gae", 0), launches.get("fused_ppo_grad_f32", 0)) != \
            (1, 4 * (HOST_ENVS * HOST_T // 256)):
        fail(f"[train host ppo_lag pointgoal_mj] launches {launches}")
    venv.close()
    out["pointgoal_mj"] = launches
    return out


def phase_grid_filter(n_pts: int = 200_000, target: int = 4096):
    """The trajectory buffer's C++ grid filter, built with the host's
    compiler, against its plain numpy version on a skewed cloud of 2-D
    points: the same count, no duplicates, and the same occupied grid
    cells covered; both timed once on the host clock."""
    import numpy as np
    from fsrl_torch.data.traj_buf import TrajectoryBuffer
    from fsrl_torch.native import build, grid_filter_native
    t0 = time.time()
    so = build()
    build_s = time.time() - t0
    rng = np.random.default_rng(0)
    pts = np.concatenate([0.1 * rng.normal(size=(n_pts - n_pts // 100, 2)),
                          rng.uniform(5, 50, (n_pts // 100, 2))])
    t0 = time.time()
    kept = grid_filter_native(pts, target, seed=0)
    native_ms = 1e3 * (time.time() - t0)
    t0 = time.time()
    plain = TrajectoryBuffer.filter_points(pts, target,
                                           np.random.default_rng(0))
    plain_ms = 1e3 * (time.time() - t0)
    g = int(np.ceil(np.sqrt(target)))
    lo, span = pts.min(0), np.maximum(pts.max(0) - pts.min(0), 1e-12)
    cells = lambda idx: {tuple(c) for c in np.minimum(
        (pts[idx] - lo) / span * g, g).astype(int)}
    covered, every = cells(kept), cells(np.arange(n_pts))
    print(f"[grid filter] {so.name} built in {build_s:.1f} s; {n_pts} points "
          f"to {target}: native {native_ms:.1f} ms, numpy {plain_ms:.1f} ms "
          f"(host clock); cells covered native {len(covered)}, numpy "
          f"{len(cells(plain))}, occupied {len(every)}", flush=True)
    if not (len(kept) == len(set(kept)) == len(plain) == target
            and covered == cells(plain) == every):
        fail("the native grid filter disagrees with its numpy version")


def phase_breakdown(tr, tag="breakdown"):
    """Host-clock time of the iteration's two halves (collect; process +
    update) and the device's busy share of one iteration from
    ``torch.profiler``."""
    import torch
    from fsrl_torch.algos.common import process_rollout
    algo = tr.algo

    res, roll_ms = _timed(lambda: tr.rollout(
        tr.state.params, tr.env_state, tr.stats.reset_aggregates(),
        tr.generator))
    _, proc_ms = _timed(lambda: process_rollout(
        tr.state.params.critics, res.transitions, algo.hp["gamma"],
        algo.hp["gae_lambda"], episode_len=algo.hp["episode_len"]))
    (tr.state, _), upd_ms = _timed(lambda: algo.update(
        tr.state, res.transitions, res.stats.mean_cost, res.stats.n_episodes,
        tr.generator))
    tr.env_state, tr.stats = res.env_state, res.stats
    print(f"[{tag}] collect {roll_ms:.2f} ms; update {upd_ms:.2f} ms "
          f"(of which process_rollout {proc_ms:.2f} ms)", flush=True)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        torch.cuda.synchronize()
        t = time.time()
        tr._run_iter()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.time() - t)
    # device-side events only: an aten op's row repeats the time of the
    # kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    if not events:
        fail("the profiler recorded no device time")
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    n_kernels = sum(e.count for e in events)
    print(f"[{tag}] profiled iteration {wall_ms:.2f} ms wall, device "
          f"busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%), "
          f"{n_kernels} device ops", flush=True)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    for e in top:
        print(f"[{tag}]   {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<6d} {e.key[:70]}", flush=True)


def phase_train_algo(name, agent_cls, task, dtype, **algo_kw):
    """One of the trust-region / FOCOPS paths at full width: 3 iterations
    plus the test through ``learn`` with the launch counters read around
    it, then 3 timed iterations. Returns the agent and K1's launch count."""
    import torch
    from fsrl_torch.ops import kernels

    N, T, iters = N_ENVS, T_STEPS, 3
    tag = f"train {name} {'bf16' if dtype else 'f32'}"
    agent = agent_cls(task, cost_limit=10.0, compute_dtype=dtype, **algo_kw)
    if agent.algo.hidden_sizes != (128, 128):
        fail(f"{tag}: not at the full width")
    kernels.reset_launch_counts()
    info, learn_ms = _timed(lambda: agent.learn(
        epochs=1, step_per_epoch=iters * N * T, n_envs=N,
        steps_per_collect=T, episode_per_test=10))
    launches = dict(kernels.LAUNCHES)
    tr = agent.trainer
    metrics = tr.last_metrics
    print(f"[{tag}] {task}: learn(3 iterations + test) "
          f"{learn_ms / 1e3:.2f} s; launches {launches}; info {info}",
          flush=True)
    print(f"[{tag}] last metrics {metrics}", flush=True)
    if not metrics or not all(math.isfinite(v) for v in metrics.values()):
        fail(f"{tag}: non-finite or missing metrics: {metrics}")
    if not all(math.isfinite(info[k]) for k in
               ("test_reward", "test_cost", "test_length")):
        fail(f"{tag}: non-finite test result: {info}")
    if launches.get("gae", 0) < iters:
        fail(f"{tag}: GAE kernel launched {launches.get('gae', 0)} < "
             f"{iters} times")
    if any(launches.get(k, 0) for k in K2_NAMES):
        fail(f"{tag}: the PPO-Lag grad kernel is not on this path")

    collect, update, steps = _timed_iterations(agent)
    seen_term, backtracks = 0, []
    for res, m, accepted in steps:
        seen_term += int(res.transitions.terminated.sum())
        if "loss/backtracks" in m:
            backtracks.append(int(m["loss/backtracks"]))
        elif name == "trpo_lag":      # not among TRPO-Lag's metrics
            backtracks.append(int(accepted[-1]))
    c_ms, u_ms = statistics.median(collect), statistics.median(update)
    extra = f"; accepted line-search index {backtracks}" if backtracks else ""
    print(f"[{tag}] iteration {c_ms + u_ms:.2f} ms = collect {c_ms:.2f} + "
          f"update {u_ms:.2f} (medians of 3), "
          f"{N * T / ((c_ms + u_ms) / 1e3):.0f} env-steps/s; terminated "
          f"flags in the 3 collects: {seen_term}{extra}", flush=True)
    if task.startswith("SafetyDrone") and seen_term == 0:
        fail(f"{tag}: no drone crashed: the env's terminations did not "
             "reach the collector")
    agent.state = tr.state
    return agent, launches.get("gae", 0)


def phase_update_split(name, tr):
    """Where one f32 update of a trust-region algorithm goes: rollout
    processing, the actor's step (of which ten Fisher-vector products of
    one CG solve on their own) and the critic steps; host-clock ms."""
    import torch
    from fsrl_torch.algos.common import (apply_flat, critic_steps,
                                         normalize_adv, process_rollout,
                                         split_flat)
    from fsrl_torch.ops.cg import conjugate_gradient, make_fvp
    algo, model = tr.algo, tr.state.params
    hp = algo.hp
    res = tr.rollout(tr.state.params, tr.env_state,
                     tr.stats.reset_aggregates(), tr.generator)
    batch, proc_ms = _timed(lambda: process_rollout(
        model.critics, res.transitions, hp["gamma"], hp["gae_lambda"],
        episode_len=hp["episode_len"]))
    adv = normalize_adv(batch.adv)
    flat_a, flat_c = split_flat(model, tr.state.flat.clone())
    dev = flat_a.device
    if name == "trpo_lag":
        step = lambda: algo.natural_gradient_step(
            model, flat_a, batch.obs, batch.act, batch.logp_old, adv,
            torch.ones(algo.num_costs, device=dev),
            torch.tensor(0.5, device=dev))
    else:
        step = lambda: algo.trust_region_step(
            model, flat_a, batch.obs, batch.act, batch.logp_old, adv[:, 0],
            adv[:, 1], torch.tensor(12.0, device=dev), algo.cost_limit)
    out, step_ms = _timed(step)
    accepted = int(out[2] if name == "trpo_lag" else out[1]["loss/backtracks"])
    names = model.actor_names()
    with torch.no_grad():
        old = apply_flat(model.actor, names, flat_a, batch.obs)
    kl = lambda f: old.kl(apply_flat(model.actor, names, f, batch.obs)).mean()
    b = torch.randn(flat_a.shape, device=dev,
                    generator=torch.Generator(dev).manual_seed(0))
    _, cg_ms = _timed(lambda: conjugate_gradient(
        make_fvp(kl, flat_a, hp["damping"]), b, hp["cg_iters"]))
    _, crit_ms = _timed(lambda: critic_steps(
        algo.critic_tx, model.critics, model.critic_names(), flat_c,
        tr.state.critic_opt_state, batch.obs, batch.ret,
        hp["optim_critic_iters"], hp.get("l2_reg", 0.0)))
    print(f"[update split {name}] process_rollout {proc_ms:.2f} ms; actor "
          f"step {step_ms:.2f} ms (one CG solve of {hp['cg_iters']} "
          f"products alone {cg_ms:.2f} ms; line search accepted index "
          f"{accepted}); "
          f"{hp['optim_critic_iters']} critic steps {crit_ms:.2f} ms",
          flush=True)


def phase_critic_forms():
    """One whole-batch critic loss and gradient at the full width, through
    the ensemble's forward (each tower a chain of plain matmuls) and with
    every layer one matmul batched over the towers: same values and
    gradients, and the device time of each (median of 5 CUDA-event
    timings)."""
    import torch
    from fsrl_torch.nets.mlp import VCriticEnsemble

    def batched(c, obs):
        dt = c.compute_dtype or obs.dtype
        x = obs.reshape(1, -1, obs.shape[-1]).to(dt)
        for i, (w, b) in enumerate(zip(c.w, c.b)):
            x = torch.matmul(x, w.to(dt).transpose(1, 2)) + b.to(dt)[:, None]
            if i < len(c.w) - 1:
                x = torch.relu(x)
        return x[..., 0].T.float()

    def event_ms(fn):
        times = []
        for i in range(7):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            if i >= 2:                      # two warm-up calls
                times.append(start.elapsed_time(end))
        return statistics.median(times)

    D, K = 13, 2
    g = torch.Generator(device="cuda").manual_seed(0)
    # the whole batch of TRPO-Lag's and CPO's critic steps, and one of
    # FOCOPS's 8 minibatches
    for B, dtype in ((N_ENVS * T_STEPS, None),
                     (N_ENVS * T_STEPS, torch.bfloat16),
                     (N_ENVS * T_STEPS // 8, None),
                     (N_ENVS * T_STEPS // 8, torch.bfloat16)):
        obs = torch.randn(B, D, device="cuda", generator=g)
        ret = torch.randn(B, K, device="cuda", generator=g)
        c = VCriticEnsemble(D, K, (128, 128), compute_dtype=dtype,
                            generator=torch.Generator().manual_seed(1)
                            ).cuda()
        params = list(c.parameters())

        def grads(fwd):
            loss = ((ret - fwd(obs)) ** 2).mean(0).sum()
            return torch.autograd.grad(loss, params)

        with torch.no_grad():
            v_err = float((c(obs) - batched(c, obs)).abs().max())
        g_err = max(float((a - b).abs().max() / (b.abs().max() + 1e-12))
                    for a, b in zip(grads(c), grads(lambda o: batched(c, o))))
        ms = event_ms(lambda: grads(c))
        batched_ms = event_ms(lambda: grads(lambda o: batched(c, o)))
        tag = "bf16" if dtype else "f32"
        # f32: summation order; bf16: a value may round to the neighbouring
        # bf16 number (2^-8 relative) when its f32 sum came out otherwise
        tol = 2e-2 if dtype else 1e-4
        print(f"[critic forms {tag}] {B} rows, D {D}, K {K}: max |value "
              f"diff| {v_err:.3e}, worst gradient err / max|ref| "
              f"{g_err:.3e} (tol {tol:.0e}); loss + gradient {ms:.3f} ms, "
              f"every layer a batched matmul {batched_ms:.3f} ms",
              flush=True)
        if not (v_err <= tol and g_err <= tol):
            fail(f"the critic ensemble's two forms disagree ({tag})")


def phase_new_paths():
    """FOCOPS, TRPO-Lag and CPO at full width, f32 then bf16. Returns K1's
    launch counts by path and the f32 agents (for the checkpoint phase and
    the profiled breakdowns)."""
    import torch
    from fsrl_torch.agent import CPOAgent, FOCOPSAgent, TRPOLagAgent
    paths = (("focops", FOCOPSAgent, "SafetyCarCircle-v0",
              dict(repeat=4, n_minibatches=8)),
             ("trpo_lag", TRPOLagAgent, "SafetyDroneRun-v0", {}),
             ("cpo", CPOAgent, "SafetyAntRun-v0", {}))
    counts, f32_agents = {}, {}
    for name, cls, task, kw in paths:
        for dtype in (None, torch.bfloat16):
            agent, n_gae = phase_train_algo(name, cls, task, dtype, **kw)
            counts[f"{name}_{'bf16' if dtype else 'f32'}"] = n_gae
            if dtype is None:
                f32_agents[name] = agent
                if name != "focops":
                    phase_update_split(name, agent.trainer)
    return counts, f32_agents


def phase_checkpoint(agent, make_fresh, tag, learn_kw):
    """Save a state trained on the card, load it into a fresh agent
    (``make_fresh()``, another seed), compare every tensor, train one more
    iteration (``learn_kw``)."""
    import tempfile

    import torch
    from fsrl_torch.utils.checkpoint import (load_checkpoint,
                                             save_checkpoint, to_state_dict)

    def leaves(tree, prefix=""):
        if isinstance(tree, torch.Tensor):
            yield prefix, tree
        else:
            for k, v in tree.items():
                yield from leaves(v, f"{prefix}.{k}")

    # the on-policy states keep their flat vector as a field, the
    # off-policy ones on the module
    flat = lambda st: st.flat if hasattr(st, "flat") else st.params.flat
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "checkpoint", "model.pt")
        save_checkpoint(path, agent.state)
        size = os.path.getsize(path)
        fresh = make_fresh()
        if torch.equal(flat(fresh.state), flat(agent.state)):
            fail(f"[{tag}] the fresh agent already equals the trained")
        fresh.state = load_checkpoint(path, fresh.state)
    saved = dict(leaves(to_state_dict(agent.state)))
    got = dict(leaves(to_state_dict(fresh.state)))
    bad = [k for k in saved if k not in got or not torch.equal(saved[k],
                                                                got[k])]
    if bad or set(saved) != set(got) or flat(fresh.state).device.type != \
            "cuda":
        fail(f"[{tag}] restored state differs at {bad}")
    if not torch.equal(flat(fresh.state), flat(agent.state)):
        fail(f"[{tag}] the flat vector does not hold the restored "
             "parameters")
    count = int(fresh.state.update_count)
    info = fresh.learn(**learn_kw)
    ok = (int(fresh.state.update_count) > count
          and all(math.isfinite(v)
                  for v in fresh.trainer.last_metrics.values()))
    print(f"[{tag}] {len(saved)} tensors, {size} bytes, restored bit "
          f"for bit onto the card; update_count {count} -> "
          f"{int(fresh.state.update_count)}; one more iteration: {info}",
          flush=True)
    if not ok:
        fail(f"[{tag}] training did not continue from the restored state")


def _update_on(dev, algo_cls, rows, **algo_kw):
    """One small f32 update of ``algo_cls`` on ``dev``: flat parameters,
    metrics, and the flat parameters before."""
    import torch
    from fsrl_torch.types import TileLayout, Transition, draw_tile_perms
    T, N = rows["reward"].shape
    algo = algo_cls(rows["obs"].shape[-1], rows["act"].shape[-1],
                    cost_limit=5.0, device=dev, **algo_kw)
    state = algo.init(seed=1)
    start = state.flat.cpu().clone()
    tr = Transition(**{
        k: torch.as_tensor(v, dtype=torch.bool if v.dtype == bool
                           else torch.float32, device=dev)
        for k, v in rows.items()})
    extra = {}
    if algo.name in ("ppo_lag", "focops"):
        perms = draw_tile_perms(
            TileLayout.of(T * N, 2), 2, torch.Generator().manual_seed(2),
            "cpu", roll_per_epoch=algo.name == "focops")
        extra["perms"] = tuple(p.to(dev) for p in perms)
    state, m = algo.update(
        state, tr, torch.tensor([7.0], device=dev),
        torch.tensor(3, dtype=torch.int32, device=dev), None, **extra)
    m = {k: float(v) for k, v in m.items()}
    if algo.name == "trpo_lag":       # not among TRPO-Lag's metrics
        m["loss/backtracks"] = float(algo.last_backtracks[-1])
    return algo, state, start, state.flat.cpu(), m


def phase_update_parity():
    import numpy as np
    from fsrl_torch.algos.common import split_flat
    from fsrl_torch.algos.cpo import CPO
    from fsrl_torch.algos.focops import FOCOPS
    from fsrl_torch.algos.ppo_lag import PPOLag
    from fsrl_torch.algos.trpo_lag import TRPOLag
    from fsrl_torch.ops import kernels

    rng = np.random.default_rng(0)
    T, N, D, A = 32, 64, 9, 2
    rows = {
        "obs": rng.normal(size=(T, N, D)), "act": rng.normal(size=(T, N, A)),
        "obs_next": rng.normal(size=(T, N, D)),
        "reward": rng.normal(size=(T, N)), "cost": rng.random((T, N, 1)),
        "terminated": rng.random((T, N)) < 0.02,
        "truncated": rng.random((T, N)) < 0.02,
        "logp": rng.normal(size=(T, N)) - 2.0}
    mb = dict(repeat=2, n_minibatches=2)
    for cls, kw in ((PPOLag, mb), (FOCOPS, mb),
                    (TRPOLag, dict(target_kl=0.01)), (CPO, {})):
        algo, state, start, fc, mc = _update_on("cpu", cls, rows, **kw)
        before = kernels.LAUNCHES["fused_ppo_grad_f32"]
        _, _, _, fg, mg = _update_on("cuda", cls, rows, **kw)
        n_f32 = kernels.LAUNCHES["fused_ppo_grad_f32"] - before
        tag = f"update parity {algo.name}"
        # PPO-Lag's 2 x 2 grad steps go through the f32 K2 kernel
        if n_f32 != (4 if algo.name == "ppo_lag" else 0):
            fail(f"[{tag}] {n_f32} launches of the f32 grad kernel")
        loss_err, worst = max(
            (abs(mc[k] - mg[k]) / max(1.0, abs(mc[k])), k) for k in mc)
        if algo.name in ("ppo_lag", "focops"):
            # the devices sum in other orders (gradients ~1e-7 apart
            # relative); Adam's lr * m / sqrt(v) passes that on, so after
            # 4 steps (moves of ~1e-3) the weights agree to 1e-5 and the
            # losses to 1e-5
            param_err = float((fc - fg).abs().max())
            print(f"[{tag}] max |param cpu - cuda| {param_err:.3e} (tol "
                  f"1e-5); max loss rel err {loss_err:.3e} (tol 1e-5); "
                  f"f32 K2 launches {n_f32}", flush=True)
            ok = param_err <= 1e-5 and loss_err <= 1e-5
        else:
            # CG amplifies the summation order (ten unconverged
            # iterations): the actor's step is held to 5e-3 of its length
            # with the same accepted index (and optimization case). The
            # critics take 10 or 20 Adam steps: where a gradient entry is
            # rounding noise, m / sqrt(v) makes a full step of lr out of
            # it, in a direction that depends on the summation order, so
            # the critics' move as a whole is held to 2e-2 of its length
            # and no entry may differ by more than 5 steps of lr. The
            # metrics are held to 1e-2 (r, a cross term of two CG
            # solutions, to 5e-2)
            model = state.params
            (ac, cc), (ag, cg) = split_flat(model, fc), split_flat(model, fg)
            a0 = split_flat(model, start)[0]
            step_err = float((ac - ag).norm() / (ac - a0).norm())
            c0 = split_flat(model, start)[1]
            crit_err = float((cc - cg).norm() / (cc - c0).norm())
            crit_max = float((cc - cg).abs().max())
            same = all(mc[k] == mg[k] for k in
                       ("loss/backtracks", "loss/optim_case") if k in mc)
            r_err = abs(mc.get("loss/optim_R", 0.0)
                        - mg.get("loss/optim_R", 0.0))
            loss_err, worst = max(
                (abs(mc[k] - mg[k]) / max(1.0, abs(mc[k])), k)
                for k in mc if k != "loss/optim_R")
            print(f"[{tag}] actor step err / length {step_err:.3e} (tol "
                  f"5e-3); accepted index {mg['loss/backtracks']:.0f} "
                  f"(cpu {mc['loss/backtracks']:.0f})"
                  + (f", optim_case {mg['loss/optim_case']:.0f} (cpu "
                     f"{mc['loss/optim_case']:.0f}), |r cpu - cuda| "
                     f"{r_err:.3e} (tol 5e-2)" if "loss/optim_case" in mc
                     else "")
                  + f"; critics move err / length {crit_err:.3e} (tol "
                  f"2e-2), max abs err {crit_max:.3e} (tol 5e-3); max "
                  f"metric rel err {loss_err:.3e} at {worst} (tol 1e-2)",
                  flush=True)
            ok = (step_err <= 5e-3 and crit_err <= 2e-2 and crit_max <= 5e-3
                  and same and loss_err <= 1e-2 and r_err <= 5e-2)
        if not ok:
            fail(f"the CUDA update of {algo.name} disagrees with the CPU "
                 "update")


def phase_update_parity_widths(hidden=(64, 32)):
    """One small f32 PPO-Lag update at hidden ``hidden`` (K2's generic
    form) on the card against the same update on the CPU, as
    ``phase_update_parity``: 4 grad steps through the generic form's f32
    dtype and none through any other K2 form, weights within 1e-5, losses
    within 1e-5 relative."""
    import numpy as np
    from fsrl_torch.algos.ppo_lag import PPOLag
    from fsrl_torch.ops import kernels

    rng = np.random.default_rng(0)
    T, N, D, A = 32, 64, 9, 2
    rows = {
        "obs": rng.normal(size=(T, N, D)), "act": rng.normal(size=(T, N, A)),
        "obs_next": rng.normal(size=(T, N, D)),
        "reward": rng.normal(size=(T, N)), "cost": rng.random((T, N, 1)),
        "terminated": rng.random((T, N)) < 0.02,
        "truncated": rng.random((T, N)) < 0.02,
        "logp": rng.normal(size=(T, N)) - 2.0}
    kw = dict(repeat=2, n_minibatches=2, hidden_sizes=hidden)
    tag = f"update parity h{'x'.join(map(str, hidden))}"
    _, _, _, fc, mc = _update_on("cpu", PPOLag, rows, **kw)
    kernels.reset_launch_counts()
    _, _, _, fg, mg = _update_on("cuda", PPOLag, rows, **kw)
    launches = dict(kernels.LAUNCHES)
    param_err = float((fc - fg).abs().max())
    loss_err, worst = max(
        (abs(mc[k] - mg[k]) / max(1.0, abs(mc[k])), k) for k in mc)
    print(f"[{tag}] max |param cpu - cuda| {param_err:.3e} (tol 1e-5); max "
          f"loss rel err {loss_err:.3e} at {worst} (tol 1e-5); launches "
          f"{launches}", flush=True)
    if not k2_only(launches, "fused_ppo_grad_any_f32", 4):
        fail(f"[{tag}] expected 4 launches of the generic f32 form, got "
             f"{launches}")
    if not (param_err <= 1e-5 and loss_err <= 1e-5):
        fail(f"[{tag}] the CUDA update disagrees with the CPU update")


def phase_update_parity_nav():
    """One f32 PPO-Lag update on rows of the navigation task (observation
    21: the wide f32 kernel) on the card against the same update on the
    CPU, as ``phase_update_parity`` at D 9: 4 grad steps through the f32
    K2 kernel, weights within 1e-5, losses within 1e-5 relative."""
    import numpy as np
    import torch
    from fsrl_torch.algos.ppo_lag import PPOLag
    from fsrl_torch.envs import make
    from fsrl_torch.ops import kernels

    env = make(NAV_TASK)
    T, N = 32, 64
    g = torch.Generator().manual_seed(0)
    state = env.reset_vec(N, g, stagger=True)
    cols = {k: [] for k in ("obs", "act", "obs_next", "reward", "cost",
                            "terminated", "truncated")}
    for _ in range(T):
        act = 2 * torch.rand(N, env.action_size, generator=g) - 1
        obs = state.obs
        state, ts = env.step_autoreset(state, act, g)
        for k, v in (("obs", obs), ("act", act), ("obs_next", ts.obs),
                     ("reward", ts.reward), ("cost", ts.cost),
                     ("terminated", ts.terminated),
                     ("truncated", ts.truncated)):
            cols[k].append(v.numpy())
    rows = {k: np.stack(v) for k, v in cols.items()}
    rows["logp"] = np.random.default_rng(0).normal(size=(T, N)) - 2.0
    kw = dict(repeat=2, n_minibatches=2)
    _, _, _, fc, mc = _update_on("cpu", PPOLag, rows, **kw)
    before = kernels.LAUNCHES["fused_ppo_grad_f32"]
    _, _, _, fg, mg = _update_on("cuda", PPOLag, rows, **kw)
    n_f32 = kernels.LAUNCHES["fused_ppo_grad_f32"] - before
    param_err = float((fc - fg).abs().max())
    loss_err = max(abs(mc[k] - mg[k]) / max(1.0, abs(mc[k])) for k in mc)
    tag = "update parity ppo_lag nav"
    print(f"[{tag}] {NAV_TASK} rows (D {rows['obs'].shape[-1]}), costs "
          f"{rows['cost'].sum():.0f}: max |param cpu - cuda| "
          f"{param_err:.3e} (tol 1e-5); max loss rel err {loss_err:.3e} "
          f"(tol 1e-5); f32 K2 launches {n_f32}", flush=True)
    if n_f32 != 4 or param_err > 1e-5 or loss_err > 1e-5:
        fail(f"[{tag}] the CUDA update disagrees with the CPU update")


def _gae_case(T: int, N: int, K: int):
    """K1 against its plain version at one shape: max abs error (must be
    0) and the inputs, for timing."""
    import torch
    from fsrl_torch.ops.gae import gae_advantages
    from fsrl_torch.ops.gae_kernel import gae_advantages_fused

    g = torch.Generator(device="cuda").manual_seed(T)
    m, v, vn = (torch.randn(T, N, K, device="cuda", generator=g)
                for _ in range(3))
    end = torch.rand(T, N, device="cuda", generator=g) < 0.05
    args = (m, v, vn, end, 0.99, 0.95)
    adv_k, ret_k = gae_advantages_fused(*args)
    adv_2, ret_2 = gae_advantages_fused(*args)
    adv_p, ret_p = gae_advantages(*args)
    torch.cuda.synchronize()
    err = max(float((adv_k - adv_p).abs().max()),
              float((ret_k - ret_p).abs().max()))
    same = torch.equal(adv_k, adv_2) and torch.equal(ret_k, ret_2)
    # same operation order as the plain loop, no FMA contraction: the
    # kernel must equal it bit for bit
    print(f"[K1 gae ({T}, {N}, {K})] max abs err {err:.3e} (tol 0); two "
          f"launches identical: {same}", flush=True)
    if err != 0.0 or not same:
        fail(f"GAE kernel disagrees with its plain version at {(T, N, K)}")
    return err, args


def phase_gae():
    from fsrl_torch.ops import kernels
    from fsrl_torch.ops.gae import gae_advantages
    from fsrl_torch.ops.gae_kernel import (STRIP, TIME_TILE,
                                           gae_advantages_fused)

    lib = kernels.library()
    if (lib.fsrl_gae_strip(), lib.fsrl_gae_time_tile()) != (STRIP, TIME_TILE):
        fail("gae_kernel.py's STRIP / TIME_TILE are not the kernel's")
    # ragged strip; T above one time tile with a ragged tile; a column
    # count that is no multiple of 4 (4-byte accesses)
    for shape in ((33, 1000, 3), (2 * TIME_TILE + 22, 500 + STRIP // 2, 2),
                  (TIME_TILE + 1, 1001, 3)):
        _gae_case(*shape)
    T, N, K = 64, 4096, 2
    err, args = _gae_case(T, N, K)
    ms = time_ms(lambda: gae_advantages_fused(*args))
    plain_ms = time_ms(lambda: gae_advantages(*args))
    empty_ms = time_ms(kernels.empty_launch)
    nbytes = 5 * 4 * T * N * K + T * N
    flops = 6 * T * N * K
    bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S)
    print(f"[K1 gae] kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms "
          f"{bound_ms:.4f} ({nbytes} bytes)", flush=True)
    print(f"[empty kernel] ms {empty_ms:.4f} (one launch replayed from a "
          f"CUDA graph, as the kernels are timed)", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes")


def _k2_inputs(K: int, bf16: bool, B: int = 32768, D: int = 9, A: int = 2,
               off_kinks: bool = True, seed: int | None = None,
               hidden=(128, 128)):
    """Arguments of K2 at one shape, drawn from ``seed`` (default ``K``),
    half the rows with ratio == 1 exactly in the plain version: the tie
    case of every epoch's first grad step. For f32 (``off_kinks``) no row
    lies within rounding of a ReLU kink, where two float32 computations may
    take different sides of the ReLU (``relu_margin``)."""
    import torch
    from fsrl_torch.algos.common import normalize_adv
    from fsrl_torch.algos.ppo_lag import PPOLag
    from fsrl_torch.ops.fused_ppo_grad import policy_logp

    algo = PPOLag(D, A, num_costs=K - 1, cost_limit=[10.0] * (K - 1),
                  hidden_sizes=hidden, device="cuda")
    state = algo.init(seed=3)
    flat, layout = state.flat, algo.grad_layout
    g = torch.Generator(device="cuda").manual_seed(K if seed is None else seed)
    obs = torch.randn(B, D, device="cuda", generator=g)
    if not bf16 and off_kinks:
        from fsrl_torch.ops.fused_ppo_grad import redraw_near_kinks
        obs = redraw_near_kinks(flat, layout, obs, lambda n: torch.randn(
            n, D, device="cuda", generator=g))
    act = torch.clamp(0.5 * torch.randn(B, A, device="cuda", generator=g),
                      -0.99, 0.99)
    logp = policy_logp(flat, layout, obs, act, bf16=bf16)
    noise = 0.1 * torch.randn(B, device="cuda", generator=g)
    even = torch.arange(B, device="cuda") % 2 == 0
    logp_old = torch.where(even, logp, logp + noise).contiguous()
    adv = normalize_adv(torch.randn(B, K, device="cuda", generator=g))
    ret = torch.randn(B, K, device="cuda", generator=g)
    lam = torch.linspace(0.5, 2.0, K - 1, device="cuda")
    resc = 1.0 / (lam.sum() + 1.0)
    return (flat, layout, obs, act, logp_old, adv, ret, lam, resc)


def _plain64(args, **kw):
    """The plain version evaluated in float64 on the same float32 inputs:
    the exact answer the f32 kernel and the plain f32 version both
    approximate."""
    import torch
    from fsrl_torch.ops.fused_ppo_grad import ppo_grad_plain
    return ppo_grad_plain(*(x.double() if torch.is_tensor(x) else x
                            for x in args), **kw)


def _tensor_errs(layout, g, ref):
    """Per gradient tensor, max |g - ref| over max |ref|."""
    return {name: float((v - ref_v).abs().max())
            / (float(ref_v.abs().max()) + 1e-12)
            for (name, v), ref_v in zip(layout.views(g).items(),
                                        layout.views(ref).values())}


def _aux_err(a, ref):
    """Max over the aux row of |a - ref| / (|ref| + 1)."""
    return float(((a.double() - ref.double()).abs()
                  / (ref.double().abs() + 1.0)).max())


def _aux_excess(a, ap, a64, B: int):
    """How much farther from the float64 evaluation ``a64`` the aux row
    ``a`` lies than the plain f32 version's ``ap``, relative to
    |a64| + B / 1000: the f32 aux tolerance 1e-5 is then rtol 1e-5 plus
    1e-8 for each of the B rows. An entry is a sum over the rows that the
    update divides by B (the KL, the surrogate, the value loss, the cost
    terms), and each row's float32 rounding of its ratio (~1e-7) adds up to
    ~sqrt(B) 1e-7 where the sum cancels: more than a fixed 1e-5 at 32,768
    rows in any float32 computation, 1e-8 on the mean the update reads."""
    a, ap = a.double(), ap.double()
    return float((((a - a64).abs() - (ap - a64).abs())
                  / (a64.abs() + B / 1000)).max())


def _k2_case(K: int, bf16: bool, B: int = 32768, D: int = 9, A: int = 2,
             timed: bool = True, hidden=(128, 128)):
    """K2 at one shape against its plain version (two launches bit for bit)
    and, if ``timed``, its time, the plain version's and its bound. The
    generic form's cases are tagged "K2 any" and carry their widths."""
    import torch
    from fsrl_torch.ops import kernels
    from fsrl_torch.ops.fused_ppo_grad import (kernel_form, launch_name,
                                               ppo_grad_plain, ppo_grad_rows,
                                               reduce_launch)

    args = _k2_inputs(K, bf16, B, D, A, hidden=hidden)
    layout = args[1]
    kw = dict(eps_clip=0.2, vf_coef=0.25, bf16=bf16)
    name = launch_name(layout, bf16)
    before = kernels.LAUNCHES[name]
    gk, ak = ppo_grad_rows(*args, **kw)
    g2, a2 = ppo_grad_rows(*args, **kw)
    counted = kernels.LAUNCHES[name] - before
    gp, ap = ppo_grad_plain(*args, **kw)
    torch.cuda.synchronize()
    # bf16: both round the same f32 values to bf16, but f32 sums taken in
    # another order can round an operand to the neighbouring bf16 value
    # (2^-8 relative), so each gradient tensor is held to 1e-2 of its
    # largest entry; f32: three TF32 products for each product, held as the
    # plain version is held to JAX's Pallas kernel on the CPU, 1e-5
    rel_tol = 1e-2 if bf16 else 1e-5
    worst = max(_tensor_errs(layout, gk, gp).values())
    max_abs = float((gk - gp).abs().max())
    aux_err = _aux_err(ak, ap)
    aux_ok = aux_err <= rel_tol
    extra = ""
    if not bf16:
        # The aux entries are sums over the rows (sum(logp_old - logp),
        # sum(ratio * cadv), ...). Half the rows have ratio exactly 1 only
        # in the plain version's own float32 rounding of logp, and every row
        # carries the same rounding of the constant terms of logp, so at
        # 32,768 rows the plain version is itself well over 1e-5 from the
        # float64 evaluation and cannot be the yardstick at rtol 1e-5. The
        # f32 aux row must be no farther from the float64 evaluation than
        # the plain f32 version, within _aux_excess's tolerance; its
        # distance from the plain version is printed as the aux error all
        # the same
        a64 = _plain64(args, **kw)[1]
        excess = _aux_excess(ak, ap, a64, B)
        aux_ok = excess <= rel_tol
        extra = (f" (not a criterion); vs float64 kernel / plain f32 aux "
                 f"{_aux_err(ak, a64):.3e} / {_aux_err(ap, a64):.3e}, kernel "
                 f"beyond plain {excess:.3e} (tol {rel_tol:.0e})")
    same = torch.equal(gk, g2) and torch.equal(ak, a2)
    generic = kernel_form(layout) == "any"
    widths = f" H={layout.H}x{layout.H2}" if generic else ""
    tag = (f"{'K2 any' if generic else 'K2'} B={B} D={D}{widths} A={A} "
           f"K={K} {'bf16' if bf16 else 'f32'}")
    print(f"[{tag}] max abs err {max_abs:.3e}, worst err / max|ref| "
          f"{worst:.3e} (tol {rel_tol:.0e}), aux rel err {aux_err:.3e}"
          f"{f' (tol {rel_tol:.0e})' if bf16 else ''}{extra}; two launches "
          f"identical: {same}; launches of {name}: {counted}", flush=True)
    if not (worst <= rel_tol and aux_ok and same and counted == 2):
        fail(f"fused grad kernel disagrees with its plain version ({tag})")
    if not timed:
        return None
    ms = time_ms(lambda: ppo_grad_rows(*args, **kw))
    plain_ms = time_ms(lambda: ppo_grad_plain(*args, **kw))
    # the generic form's launches are timed apart in phase_k2_any_split
    reduce = "" if generic else (
        f" (of which the reduce launch "
        f"{time_ms(lambda: reduce_launch(layout, B)):.4f})")
    H1, H2 = layout.H, layout.H2
    outs = [A] + [1] * K                    # head widths of the towers
    mm_flop = B * sum(6 * H1 * H2 + 4 * D * H1 for _ in outs)
    head_flop = B * sum(6 * H2 * o for o in outs)
    flops = mm_flop + head_flop
    nbytes = 4 * (B * (D + A + 1 + 2 * K) + 2 * layout.size + 8)
    fp32_s = flops / F32_FLOP_PER_S
    # bf16: every FLOP at the bf16 tensor-core rate; f32: the products three
    # times at the TF32 rate, the heads on the FP32 pipes
    ops_s = flops / BF16_FLOP_PER_S if bf16 else \
        3 * mm_flop / TF32_FLOP_PER_S + head_flop / F32_FLOP_PER_S
    bound_ms = 1e3 * max(ops_s, nbytes / HBM_BYTES_PER_S)
    bound_by = "operations" if ops_s > nbytes / HBM_BYTES_PER_S else "bytes"
    extra = "" if bf16 else f", {1e3 * fp32_s:.4f} on the FP32 pipes alone"
    print(f"[{tag}] kernel_ms {ms:.4f}{reduce} plain_ms {plain_ms:.4f} "
          f"bound_ms {bound_ms:.4f}{extra} ({flops} FLOP, {nbytes} bytes)",
          flush=True)
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def phase_k2_f32_natural_rows(seeds=(0, 1, 2), B: int = 32768, K: int = 2,
                              D: int = 9, A: int = 2, hidden=(128, 128)):
    """The f32 kernel on the main path's rows as they are drawn, ReLU kinks
    included. A pre-activation within rounding of 0 lets two float32
    computations take different sides of the ReLU, and that row's whole
    gradient through the unit then moves, by up to ~4e-3 of a tensor's
    largest entry at 32,768 rows: the plain f32 version against a float64
    evaluation, too. So both are measured against the float64 evaluation:
    each gradient tensor of the kernel must be no farther from it than the
    plain f32 version's plus 1e-5 of its largest entry, each aux entry no
    farther than the plain version's plus 1e-5 (``_aux_excess``). Printed
    beside them: the rows with a pre-activation within 1e-6 of a kink, the
    kernel's distance from the plain version, and the pre-activations the
    kernel took again in float64 in the launch (first layer, second
    layer). At hidden widths other than (128, 128) the generic form, with
    its own retake counts. Returns the last seed's retake counts."""
    from fsrl_torch.ops.fused_ppo_grad import (kernel_form, ppo_grad_plain,
                                               ppo_grad_rows, relu_margin,
                                               retake_counts)
    kw = dict(eps_clip=0.2, vf_coef=0.25, bf16=False)
    for seed in seeds:
        args = _k2_inputs(K, False, B, D, A, off_kinks=False, seed=seed,
                          hidden=hidden)
        flat, layout, obs = args[:3]
        form = kernel_form(layout)
        retake_counts(form)
        gk, ak = ppo_grad_rows(*args, **kw)
        retakes = retake_counts(form)
        gp, ap = ppo_grad_plain(*args, **kw)
        g64, a64 = _plain64(args, **kw)
        ek, ep = _tensor_errs(layout, gk, g64), _tensor_errs(layout, gp, g64)
        name = max(ek, key=lambda n: ek[n] - ep[n])
        excess = _aux_excess(ak, ap, a64, B)
        near = int((relu_margin(flat, layout, obs) < 1e-6).sum())
        widths = (f" H={layout.H}x{layout.H2}" if form == "any" else "")
        tag = (f"{'K2 any' if form == 'any' else 'K2'} B={B} D={D}{widths} "
               f"A={A} K={K} f32 natural rows seed {seed}")
        print(f"[{tag}] vs float64, kernel / plain f32: worst tensor "
              f"{max(ek.values()):.3e} / {max(ep.values()):.3e}, nearest "
              f"the bound {name} {ek[name]:.3e} / {ep[name]:.3e} (tol: plain "
              f"+ 1e-5); aux {_aux_err(ak, a64):.3e} / "
              f"{_aux_err(ap, a64):.3e}, kernel beyond plain {excess:.3e} "
              f"(tol 1e-5); kernel vs plain "
              f"{max(_tensor_errs(layout, gk, gp).values()):.3e} (aux "
              f"{_aux_err(ak, ap):.3e}); rows within 1e-6 of a kink {near}; "
              f"float64 retakes {retakes[0]} first layer, {retakes[1]} "
              f"second, of {B * (layout.H + layout.H2) * (K + 1)} "
              f"pre-activations",
              flush=True)
        if ek[name] > ep[name] + 1e-5 or excess > 1e-5:
            fail(f"[{tag}] the f32 kernel is farther from float64 than the "
                 f"plain f32 version")
    return retakes


def phase_k2_scaling(full_ms: float, bf16: bool, B: int = 32768, K: int = 2):
    """Splits the main-path time of a K2 kernel into a cost per 128-row
    chunk and a fixed cost (launches, weights, partials, reduce), from a
    second timing at one chunk per block."""
    from fsrl_torch.ops import kernels
    # blocks per tower, as the library picks them for B rows
    blocks = kernels.library().fsrl_ppo_grad_blocks(B, K)
    walk = -(-(B // 128) // blocks)          # chunks of the longest block
    one_ms = _k2_case(K, bf16, B=128 * blocks)["ms"]
    per_chunk = (full_ms - one_ms) / (walk - 1)
    tag = "K2 scaling" if bf16 else "K2 scaling f32"
    print(f"[{tag}] {walk} chunks a block {full_ms:.4f} ms, 1 chunk a "
          f"block {one_ms:.4f} ms: {1e3 * per_chunk:.2f} us a chunk, "
          f"{1e3 * (one_ms - per_chunk):.2f} us fixed", flush=True)


def _dp_share() -> int:
    """The rows rank 0 of two holds in a minibatch of the data-parallel
    PPO-Lag path at ``dp_blocks`` 1 (the global shuffle, 262,144 rows, 8
    minibatches), drawn as that path draws its tiles: the first minibatch
    whose share is not half."""
    import torch
    from fsrl_torch.types import (TileLayout, draw_tile_perms,
                                  minibatch_row_index)
    n = N_ENVS * T_STEPS
    layout = TileLayout.of(n, 8)
    g = torch.Generator(device="cuda").manual_seed(DP_SEED)
    rows = minibatch_row_index(layout, *draw_tile_perms(layout, 4, g,
                                                        "cuda"))
    shares = (rows < n // DP_WORLD).sum(1).tolist()
    return next(c for c in shares if c != layout.mb_rows // DP_WORLD)


def phase_k2_edges():
    """Both K2 kernels at the edges of their envelope: errors only. The
    data-parallel path's row counts at D 9: a rank's half of a minibatch
    (16,384 rows, ``dp_blocks`` 2) and an uneven share (``dp_blocks`` 1,
    ``_dp_share``). The
    widened envelope: x and W1 in 1 to 4 16-deep steps (D 13 to 64), the
    f32 kernel's wide form from D 13, the corner D 64, A 4, K 6; the
    instances for 5 to 8 actions at D 9, 17 and 64 with the most value
    channels (K 6), at the host path's minibatch (256 rows), and at
    ragged row counts; above D 64 (the bf16 kernel's slices of x and W1,
    the f32 kernel's P4 slices) at 65, 105, 129, 348 and Humanoid-v4's
    376, above 8 actions (the AMAX instances) at 9, 16, 17 and 24, the
    corner (348, 17, K 6) and the envelope's 32 actions, at 256 rows and
    at ragged counts."""
    wide_d = [*(dict(K=2, B=4096, D=D) for D in (65, 105, 129, 348, 376)),
              *(dict(K=2, B=4096, D=17, A=A) for A in (9, 16, 17, 24)),
              dict(K=6, B=4096, D=348, A=17), dict(K=2, B=256, D=348, A=17),
              dict(K=2, B=256, D=105, A=8), dict(K=3, B=1000, D=348, A=17),
              dict(K=2, B=100, D=105, A=8), dict(K=4, B=1000, D=376, A=24),
              dict(K=2, B=100, D=129, A=9), dict(K=6, B=1000, D=9, A=32)]
    wide_a = [*(dict(K=6, B=4096, D=D, A=A) for D in (9, 17, 64)
                for A in (6, 8)),
              *(dict(K=2, B=256, D=D, A=A) for D in (9, 17, 64)
                for A in (6, 8)),
              dict(K=3, B=1000, D=17, A=6), dict(K=2, B=100, D=64, A=8),
              dict(K=4, B=640, D=33, A=7), dict(K=2, B=200, D=9, A=5)]
    share = _dp_share()
    print(f"[K2 edges] a dp_blocks 1 minibatch's uneven share on rank 0: "
          f"{share} rows", flush=True)
    dp_rows = [dict(K=2, B=16384), dict(K=2, B=share)]
    for bf16 in (True, False):
        for kw in dp_rows + wide_a + wide_d:
            _k2_case(bf16=bf16, timed=False, **kw)
        for kw in (dict(K=2, B=1000), dict(K=2, B=100), dict(K=1, B=4096),
                   dict(K=6, B=4096), dict(K=2, B=4096, D=12, A=4),
                   dict(K=2, B=4096, D=1), dict(K=3, B=1000, D=5, A=3),
                   dict(K=2, B=4096, D=8, A=1),
                   *(dict(K=2, B=4096, D=D) for D in (13, 16, 17, 21, 32,
                                                     54, 64)),
                   dict(K=6, B=4096, D=64, A=4), dict(K=2, B=1000, D=21),
                   dict(K=3, B=100, D=54, A=3)):
            _k2_case(bf16=bf16, timed=False, **kw)


# K2's generic form, (D, H1, H2, A, K, B, timed): the width phases'
# minibatch at hidden (256, 256) and (64, 64); the 40-action host path's
# minibatch and the same width at 32,768 rows; above 32 actions at the
# default width; uneven widths; the most value channels with uneven widths
# and a ragged count; the narrowest case (D 1, A 1, K 1, 100 rows); hidden
# (512, 512) at Ant-v5's widths (W2 in float32 is 1 MB: streamed); rows
# below one 64-row block of the row kernel (1 and 63) and one row past it
K2_ANY_CASES = [(9, 256, 256, 2, 2, 32768, True),
                (9, 64, 64, 2, 2, 32768, True),
                (348, 128, 128, 40, 2, 256, True),
                (348, 128, 128, 40, 2, 32768, False),
                (9, 128, 128, 33, 2, 4096, False),
                (9, 128, 128, 128, 2, 4096, False),
                (21, 256, 128, 3, 3, 4096, False),
                (17, 32, 48, 33, 6, 1000, False),
                (1, 16, 16, 1, 1, 100, False),
                (105, 512, 512, 8, 2, 4096, False),
                (9, 256, 256, 2, 2, 1, False),
                (9, 256, 256, 2, 2, 63, False),
                (348, 128, 128, 40, 2, 65, False),
                (105, 512, 512, 8, 2, 63, False)]


def phase_k2_any():
    """K2's generic form against its plain version in both dtypes at every
    case of ``K2_ANY_CASES`` (``_k2_case``: half the rows with ratio == 1,
    f32 rows drawn clear of the ReLU kinks, the tuned forms' tolerances,
    two launches bit for bit), the timed ones also timed. Returns the
    timed cases' results by (D, H1, H2, A, B, bf16)."""
    out = {}
    for bf16 in (True, False):
        for D, H1, H2, A, K, B, timed in K2_ANY_CASES:
            r = _k2_case(K, bf16, B=B, D=D, A=A, timed=timed,
                         hidden=(H1, H2))
            if timed:
                out[D, H1, H2, A, B, bf16] = r
    return out


def phase_k2_any_split(k2_any: dict) -> dict:
    """Each of the generic form's three launches alone (``any_launches``),
    timed as the whole form is, at the timed cases of ``K2_ANY_CASES``, with
    its share of the three launches' sum and the whole form's time beside
    it. Returns the launches' ms by the case's key."""
    from fsrl_torch.ops.fused_ppo_grad import ANY_LAUNCHES, any_launches
    out = {}
    for bf16 in (True, False):
        for D, H1, H2, A, K, B, timed in K2_ANY_CASES:
            if not timed:
                continue
            args = _k2_inputs(K, bf16, B, D, A, hidden=(H1, H2))
            fns = any_launches(*args, eps_clip=0.2, vf_coef=0.25, bf16=bf16)
            ms = [time_ms(fn) for fn in fns]
            whole = k2_any[D, H1, H2, A, B, bf16]["ms"]
            tag = (f"K2 any split B={B} D={D} H={H1}x{H2} A={A} K={K} "
                   f"{'bf16' if bf16 else 'f32'}")
            print(f"[{tag}] " + ", ".join(
                f"{name} {t:.4f} ms ({100 * t / sum(ms):.1f}%)"
                for name, t in zip(ANY_LAUNCHES, ms))
                + f"; sum {sum(ms):.4f}, the whole form {whole:.4f} ms",
                flush=True)
            out[D, H1, H2, A, B, bf16] = dict(zip(ANY_LAUNCHES, ms))
    return out


def phase_autograd(B: int = 32768, D: int = 21, A: int = 2,
                   name: str = "nav", hidden=(128, 128)):
    """The autograd step PPO-Lag took outside K2's earlier envelopes (D >
    12, then D > 64 or A > 8, then other hidden widths), timed once at a
    path's width: host-clock ms a call, the device drained before and
    after, median of 5 after 2 warm-up calls."""
    import torch
    from fsrl_torch.algos.common import OnPolicyBatch
    from fsrl_torch.algos.ppo_lag import PPOLag

    args = _k2_inputs(2, False, B, D, A, hidden=hidden)
    algo = PPOLag(D, A, cost_limit=[10.0], hidden_sizes=hidden,
                  device="cuda")
    state = algo.init(seed=3)
    obs, act, logp_old, adv, ret, lam, resc = args[2:]
    mb = OnPolicyBatch(obs, act, logp_old, adv, ret, torch.zeros_like(ret))
    times = []
    for i in range(7):
        _, ms = _timed(lambda: algo._autograd_step(state, mb, lam, resc))
        if i >= 2:
            times.append(ms)
    ms = statistics.median(times)
    print(f"[autograd step {name}] B={B} D={D} hidden {hidden} A={A} K=2 "
          f"f32: {ms:.3f} ms a grad step (host clock, median of 5)",
          flush=True)
    return ms


# the JAX package's off-policy benchmark shape (bench.py:184-186,
# benchmarks/bench_offpolicy.py:31-41)
OFF_TASK, OFF_ENVS, OFF_T, OFF_UPS = "SafetyBallCircle-v0", 32, 100, 0.2
OFF_LEARN = dict(n_envs=OFF_ENVS, steps_per_collect=OFF_T,
                 buffer_size=100000, update_per_step=OFF_UPS)


def _offpolicy_agent(name, **kw):
    from fsrl_torch.agent import CVPOAgent, DDPGLagAgent, SACLagAgent
    cls = {"ddpg_lag": DDPGLagAgent, "sac_lag": SACLagAgent,
           "cvpo": CVPOAgent}[name]
    return cls(OFF_TASK, cost_limit=10.0, hidden_sizes=(128, 128),
               batch_size=256, **kw)


def phase_train_offpolicy(name, dtype=None, iters=3):
    """One off-policy path at the benchmark shape: ``iters`` iterations
    plus the test through ``learn``, with the launch counters zeroed before
    and read after. The trainer's ``collect`` and ``update`` are wrapped
    for the run, so each iteration's two halves are timed on the host
    clock (the device drained before and after each). Returns the
    agent."""
    from fsrl_torch.ops import kernels
    from fsrl_torch.trainer import OffpolicyTrainer

    tag = f"train {name}{' bf16' if dtype else ''}"
    agent = _offpolicy_agent(name, compute_dtype=dtype)
    times = {"collect": [], "update": []}
    orig = {k: getattr(OffpolicyTrainer, k) for k in times}

    launch_log = []

    def timed_method(k):
        def run(self):
            out, ms = _timed(lambda: orig[k](self))
            times[k].append(ms)
            if k == "update":
                launch_log.append((kernels.LAUNCHES.get("gae", 0),
                                   sum(kernels.LAUNCHES.get(k, 0)
                                       for k in K2_NAMES)))
            return out
        return run

    kernels.reset_launch_counts()
    for k in times:
        setattr(OffpolicyTrainer, k, timed_method(k))
    try:
        info, learn_ms = _timed(lambda: agent.learn(
            epochs=1, step_per_epoch=iters * OFF_ENVS * OFF_T,
            episode_per_test=10, **OFF_LEARN))
    finally:
        for k, f in orig.items():
            setattr(OffpolicyTrainer, k, f)
    launches = dict(kernels.LAUNCHES)
    tr = agent.trainer
    metrics = tr.last_metrics
    n_upd = tr.n_updates
    print(f"[{tag}] {OFF_TASK}, {OFF_ENVS} envs x {OFF_T} steps, {n_upd} "
          f"grad steps per collect, batch {agent.algo.hp['batch_size']}, "
          f"buffer {tr.buffer.C} x {tr.buffer.N}: learn({iters} iterations "
          f"+ test) {learn_ms / 1e3:.2f} s; K1 launches "
          f"{launches.get('gae', 0)}, K2 bf16 "
          f"{launches.get('fused_ppo_grad', 0)}, K2 f32 "
          f"{launches.get('fused_ppo_grad_f32', 0)}; info {info}",
          flush=True)
    for i, (c_ms, u_ms, (k1, k2)) in enumerate(zip(
            times["collect"], times["update"], launch_log)):
        print(f"[{tag}] iteration {i}: {c_ms + u_ms:.2f} ms = collect "
              f"{c_ms:.2f} + update {u_ms:.2f} ({u_ms / n_upd:.3f} ms per "
              f"grad step), {OFF_ENVS * OFF_T / ((c_ms + u_ms) / 1e3):.0f} "
              f"env-steps/s; K1 / K2 launches so far {k1} / {k2}",
              flush=True)
    print(f"[{tag}] last metrics {metrics}", flush=True)
    if len(times["update"]) != iters or n_upd != round(
            OFF_UPS * OFF_ENVS * OFF_T):
        fail(f"{tag}: {len(times['update'])} iterations of {n_upd} grad "
             "steps")
    if int(agent.state.gradient_steps) != iters * n_upd:
        fail(f"{tag}: {int(agent.state.gradient_steps)} grad steps in "
             f"{iters} iterations")
    if not metrics or not all(math.isfinite(v) for v in metrics.values()):
        fail(f"{tag}: non-finite or missing losses: {metrics}")
    if not all(math.isfinite(info[k]) for k in
               ("test_reward", "test_cost", "test_length")):
        fail(f"{tag}: non-finite test result: {info}")
    if sum(launches.values()):
        fail(f"{tag}: a PPO kernel launched on an off-policy path: "
             f"{launches}")
    return agent


def _offpolicy_step_on(dev, name, rows, draws):
    """One ``update_step`` of ``name`` on ``dev`` from the seed-1 state on
    a buffer holding ``rows``: the flat parameters before and after, and
    the metrics."""
    import torch
    from fsrl_torch.algos.cvpo import CVPO
    from fsrl_torch.algos.ddpg_lag import DDPGLag
    from fsrl_torch.algos.offpolicy_base import make_nstep_view
    from fsrl_torch.algos.sac_lag import SACLag
    from fsrl_torch.data.buffer import ReplayBuffer
    from fsrl_torch.types import Transition
    cls = {"ddpg_lag": DDPGLag, "sac_lag": SACLag, "cvpo": CVPO}[name]
    T, N, D = rows["obs"].shape
    A = rows["act"].shape[-1]
    algo = cls(D, A, cost_limit=5.0, batch_size=256, device=dev)
    state = algo.init(seed=1)
    state.lag.multiplier.fill_(0.5)
    start = state.params.flat.cpu().clone()
    buf = ReplayBuffer(2 * T, N, dev)
    bs = buf.init(D, A)
    for half in (slice(0, T // 2), slice(T // 2, T)):
        bs = buf.add_segment(bs, Transition(**{
            k: torch.as_tensor(v[half], device=dev,
                               dtype=torch.bool if v.dtype == bool
                               else torch.float32)
            for k, v in rows.items()}))
    state, m = algo.update_step(
        state, buf, bs, view=make_nstep_view(buf, bs),
        draws={k: v.to(dev) for k, v in draws.items()})
    return algo, start, state.params.flat.cpu(), {k: float(v)
                                                 for k, v in m.items()}


def phase_offpolicy_parity():
    """One f32 ``update_step`` of each off-policy algorithm on the card and
    on the CPU, from the same state and buffer with the same injected
    indices and normal draws."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    T, N, D, A, B = 40, 16, 8, 2, 256
    rows = {
        "obs": rng.normal(size=(T, N, D)), "act": rng.normal(size=(T, N, A)),
        "obs_next": rng.normal(size=(T, N, D)),
        "reward": rng.normal(size=(T, N)), "cost": rng.random((T, N, 1)),
        "terminated": rng.random((T, N)) < 0.03,
        "truncated": rng.random((T, N)) < 0.03,
        "logp": np.zeros((T, N))}
    g = torch.Generator().manual_seed(3)
    draws = dict(rows=torch.randint(0, T, (B,), generator=g),
                 envs=torch.randint(0, N, (B,), generator=g),
                 noise_t=torch.randn(B, A, generator=g),
                 noise_a=torch.randn(B, A, generator=g),
                 noise_p=torch.randn(16, B, A, generator=g))
    for name in ("ddpg_lag", "sac_lag", "cvpo"):
        algo, start, fc, mc = _offpolicy_step_on("cpu", name, rows, draws)
        _, _, fg, mg = _offpolicy_step_on("cuda", name, rows, draws)
        # Adam's first step moves each weight by about lr * sign(g): the
        # devices' summation orders give gradients ~1e-7 apart, so the
        # weights agree to 1e-6 unless a gradient entry is rounding noise,
        # whose sign may differ (then two steps of lr); at most 1e-3 of the
        # entries may do that. Metrics: 1e-4 relative
        diff = (fc - fg).abs()
        lr_max = 1e-3
        flipped = float((diff > 1e-6).float().mean())
        loss_err, worst = max((abs(mc[k] - mg[k]) / max(1.0, abs(mc[k])), k)
                              for k in mc)
        moved = float((fc - start).abs().max())
        print(f"[offpolicy update parity {name}] max |param cpu - cuda| "
              f"{float(diff.max()):.3e} (largest move {moved:.3e}); entries "
              f"off by more than 1e-6: {flipped:.2e} (tol 1e-3, each within "
              f"2 lr = {2 * lr_max:.0e}); max metric rel err {loss_err:.3e} "
              f"at {worst} (tol 1e-4)", flush=True)
        if not (flipped <= 1e-3 and float(diff.max()) <= 2 * lr_max * 1.001
                and loss_err <= 1e-4 and set(mc) == set(mg)):
            fail(f"the CUDA update_step of {name} disagrees with the CPU")


def phase_q_forms():
    """The Q-critic ensemble's forward (one matmul chain batched over the
    M x Q towers) against one plain chain per tower: same values and
    gradients, and the device time of one critic loss and gradient at an
    off-policy batch (256 rows) and at CVPO's particle sweep (16 x 256
    rows), median of 5 CUDA-event timings."""
    import torch
    from fsrl_torch.nets.mlp import QCriticEnsemble

    def towers(c, obs, act):
        x = torch.cat([obs, act], -1)
        cols = []
        for m in range(c.num_metrics):
            for q in range(c.num_q):
                h = x
                for i, (w, b) in enumerate(zip(c.w, c.b)):
                    h = h @ w[m, q].T + b[m, q]
                    if i < len(c.w) - 1:
                        h = torch.relu(h)
                cols.append(h)
        return torch.cat(cols, 1).reshape(-1, c.num_metrics, c.num_q)

    def event_ms(fn):
        times = []
        for i in range(7):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            if i >= 2:
                times.append(start.elapsed_time(end))
        return statistics.median(times)

    D, A = 8, 2
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for B in (256, 16 * 256):
        obs = torch.randn(B, D, device="cuda", generator=g)
        act = torch.randn(B, A, device="cuda", generator=g)
        ret = torch.randn(B, 2, 2, device="cuda", generator=g)
        c = QCriticEnsemble(D, A, 2, 2, (128, 128),
                            generator=torch.Generator().manual_seed(1)).cuda()
        params = list(c.parameters())

        def grads(fwd):
            loss = ((fwd(obs, act) - ret) ** 2).mean(0).sum()
            return torch.autograd.grad(loss, params)

        with torch.no_grad():
            v_err = float((c(obs, act) - towers(c, obs, act)).abs().max())
        g_err = max(float((a - b).abs().max() / (b.abs().max() + 1e-12))
                    for a, b in zip(grads(c),
                                    grads(lambda o, a: towers(c, o, a))))
        ms = event_ms(lambda: grads(c))
        tower_ms = event_ms(lambda: grads(lambda o, a: towers(c, o, a)))
        print(f"[Q critic forms] {B} rows, M 2 x Q 2 towers: max |value "
              f"diff| {v_err:.3e}, worst gradient err / max|ref| "
              f"{g_err:.3e} (tol 1e-4); loss + gradient batched "
              f"{ms:.3f} ms, one chain per tower {tower_ms:.3f} ms",
              flush=True)
        if not (v_err <= 1e-4 and g_err <= 1e-4):
            fail("the Q-critic ensemble's two forms disagree")
        out[B] = (ms, tower_ms)
    return out


def phase_offpolicy_breakdown(agent, window=32):
    """One SAC-Lag iteration with its collect and its first ``window``
    grad steps under ``torch.profiler``, the remaining steps and
    ``post_update`` on the host clock alone: device busy share, device ops
    and host ms per grad step, the largest device entries of the update.
    (Summarising a profile of all 640 grad steps, 600,000 events, takes the
    profiler about 90 s on that machine; the steps are alike.)"""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    tr, algo = agent.trainer, agent.algo
    n_upd = tr.n_updates
    window = min(window, n_upd // 2)

    def steps(n):
        for _ in range(n):
            tr.state, _ = algo.update_step(tr.state, tr.buffer, tr.buf_state,
                                           tr.generator, view=tr.view)

    walls, busy, ops = {}, {}, {}
    for part, fn in (("collect", tr.collect),
                     ("update", lambda: steps(window))):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            _, walls[part] = _timed(fn)
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0]
        if not events:
            fail("the profiler recorded no device time")
        busy[part] = sum(e.self_device_time_total for e in events) / 1e3
        ops[part] = sum(e.count for e in events)
        if part == "update":
            top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    _, rest_ms = _timed(lambda: steps(n_upd - window))
    tr.state = algo.post_update(tr.state) if hasattr(algo, "post_update") \
        else tr.state
    print(f"[breakdown sac_lag] collect {walls['collect']:.2f} ms wall "
          f"(profiled), device busy {busy['collect']:.2f} ms "
          f"({100 * busy['collect'] / walls['collect']:.1f}%), "
          f"{ops['collect']} device ops; first {window} of {n_upd} grad "
          f"steps {walls['update']:.2f} ms wall (profiled), device busy "
          f"{busy['update']:.2f} ms "
          f"({100 * busy['update'] / walls['update']:.1f}%), "
          f"{ops['update'] / window:.1f} device ops and "
          f"{busy['update'] / window:.3f} ms of device time per grad step, "
          f"{walls['update'] / window:.3f} ms of host time per grad step "
          f"profiled, {rest_ms / (n_upd - window):.3f} ms not profiled",
          flush=True)
    for e in top:
        print(f"[breakdown sac_lag]   {e.self_device_time_total / 1e3:9.3f} "
              f"ms x{e.count:<6d} {e.key[:70]}", flush=True)


def phase_offpolicy():
    """The three off-policy paths at the benchmark shape, the short bf16
    SAC-Lag run, the card-against-CPU step and the checkpoint round trip.
    Returns the SAC-Lag agent (for the profiled breakdown)."""
    import torch
    # two iterations each (three before the data-parallel phases came)
    agents = {name: phase_train_offpolicy(name, iters=2)
              for name in ("ddpg_lag", "sac_lag", "cvpo")}
    phase_train_offpolicy("sac_lag", dtype=torch.bfloat16, iters=1)
    phase_offpolicy_parity()
    phase_checkpoint(agents["sac_lag"], lambda: _offpolicy_agent(
        "sac_lag", seed=11), "offpolicy checkpoint",
        dict(epochs=1, step_per_epoch=OFF_ENVS * OFF_T, episode_per_test=2,
             **OFF_LEARN))
    phase_q_forms()
    return agents["sac_lag"]


# ---------------------------------------------------------------------------
# CUDA graphs: the trainers' dispatch settings (``fuse_iters``,
# ``update_chunk``, ``rollout_unroll``), each graphed trainer against the
# eager cycle of a trainer built alike from the same seed
# ---------------------------------------------------------------------------

GRAPH_FUSE = 8          # bench.py:114, the scan-fused PPO-Lag
# the trust-region, recurrent and off-policy phases fuse 2 cycles, not
# JAX's 8 (benchmarks/bench_offpolicy.py:29): the depth is cut for the
# script's time
GRAPH_FUSE_SHORT = 2
GRAPH_UNROLL = 8
# the graphs must match the eager cycle bit for bit; a difference is a
# finding, held to tests/test_fuse_iters.py's tolerance
GRAPH_RTOL, GRAPH_ATOL = 2e-4, 2e-5


def _print_modes(where: str = "") -> None:
    """From here on, print each on- or off-policy trainer's dispatch mode
    (graphs or eager, and why), which it logs once built; a trainer built
    as the one before it prints nothing."""
    import logging
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter(f"[mode{where}] %(message)s"))
    last = [None]

    def changed(record) -> bool:
        line = record.getMessage()
        new, last[0] = line != last[0], line
        return new
    handler.addFilter(changed)
    log = logging.getLogger("fsrl_torch.trainer.trainer")
    log.addHandler(handler)
    log.setLevel(logging.INFO)


def _card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


def _graph_groups(tr) -> dict:
    """What a dispatch changes, by group, as lists of tensors: the
    training state as its checkpoint holds it, the rest as the graphs
    flatten it."""
    from fsrl_torch.trainer.graphs import flatten
    from fsrl_torch.utils.checkpoint import to_state_dict
    groups = dict(params=to_state_dict(tr.state), env=tr.env_state,
                  stats=tr.stats)
    if getattr(tr, "hidden", None) is not None:
        groups["hidden"] = tr.hidden
    if hasattr(tr, "buf_state"):
        groups["buffer"] = tr.buf_state
    return {k: flatten(v)[0] for k, v in groups.items()}


def _graph_diff(tag: str, got: dict, ref: dict) -> tuple[dict, bool]:
    """Largest absolute difference of each group and whether all are equal
    bit for bit; fails beyond the tolerance, or on any integer or flag
    that differs."""
    import torch
    diffs, exact = {}, True
    for group, tensors in got.items():
        worst = 0.0
        if len(tensors) != len(ref[group]):
            fail(f"[graph {tag}] {group}: the trees differ")
        for k, (x, y) in enumerate(zip(tensors, ref[group])):
            if x.shape != y.shape or x.dtype != y.dtype:
                fail(f"[graph {tag}] {group}[{k}]: {x.dtype} {tuple(x.shape)}"
                     f" against {y.dtype} {tuple(y.shape)}")
            if torch.equal(x, y):
                continue
            exact = False
            if not x.is_floating_point():
                fail(f"[graph {tag}] {group}[{k}] differs from the eager "
                     "cycle's")
            if not torch.allclose(x, y, rtol=GRAPH_RTOL, atol=GRAPH_ATOL,
                                  equal_nan=True):
                fail(f"[graph {tag}] {group}[{k}]: beyond rtol {GRAPH_RTOL} / "
                     f"atol {GRAPH_ATOL} of the eager cycle's")
            worst = max(worst, float((x.double() - y.double()).abs().max()))
        diffs[group] = worst
    return diffs, exact


def _k12(launches) -> dict:
    """K1's and every K2 form's launches."""
    return {k: v for k, v in dict(launches).items() if v}


def _graph_onpolicy(tag: str, make_agent, fuse: int = 1, unroll: int = 1,
                    dispatches: int = 4):
    """The on-policy trainer with ``fuse_iters`` ``fuse`` and
    ``rollout_unroll`` ``unroll`` against the eager cycle: ``dispatches``
    dispatches (the first the eager warm-up, the second the capture and
    its replay, the rest replays) and as many eager cycles; then the
    largest differences, the launches of a dispatch against the eager
    cycle's, and the ms of an iteration replayed and eager. Returns the
    graphed trainer, the eager one and the readings."""
    from fsrl_torch.ops import kernels
    from fsrl_torch.trainer import OnpolicyTrainer, graphs

    def trainer(**kw):
        agent = make_agent()
        return OnpolicyTrainer(agent.algo, agent.env, None, n_envs=N_ENVS,
                               steps_per_collect=T_STEPS, cost_limit=10.0,
                               seed=0, verbose=False, state=agent.state,
                               **kw)

    tr = trainer(fuse_iters=fuse, rollout_unroll=unroll)
    ref = trainer()
    cycles = dispatches * fuse
    kernels.reset_launch_counts()
    _, first_ms = _timed(ref.cycle)
    per_cycle = _k12(kernels.LAUNCHES)
    eager = [first_ms] + [_timed(ref.cycle)[1] for _ in range(cycles - 1)]
    kernels.reset_launch_counts()
    graphs.CAPTURES.clear()
    graphs.REPLAYS.clear()
    times = [_timed(tr._run_iter)[1] for _ in range(dispatches)]
    counted = _k12(kernels.LAUNCHES)
    diffs, exact = _graph_diff(tag, _graph_groups(tr), _graph_groups(ref))
    if tr.graph is not None:
        per_dispatch = _k12(tr.graph.launches)
        expect = {k: fuse * v for k, v in per_cycle.items()}
        # the eager warm-up and the capture are what Python counted
        path = {k: v * (1 + tr.graph.replays)
                for k, v in per_dispatch.items()}
    else:
        per_dispatch = {k: v // dispatches for k, v in counted.items()}
        expect = per_cycle
        path = counted
    if not graphs.REPLAYS or not all(
            graphs.REPLAYS[k] for k in graphs.CAPTURES):
        fail(f"[graph {tag}] no graph was replayed ({tr.dispatch_mode})")
    if per_dispatch != expect or not per_dispatch:
        fail(f"[graph {tag}] a dispatch launched {per_dispatch}, the eager "
             f"cycle {per_cycle} ({fuse} cycles a dispatch)")
    replay_ms = statistics.median(times[2:]) / fuse
    eager_ms = statistics.median(eager[1:])
    print(f"[graph {tag}] mode: {tr.dispatch_mode} (reference: "
          f"{ref.dispatch_mode}); {N_ENVS} envs x {T_STEPS} steps, "
          f"{cycles} cycles each; largest differences {diffs} "
          f"({'bit for bit' if exact else 'NOT bit for bit'}); launches a "
          f"dispatch {per_dispatch} (eager cycle {per_cycle}), "
          f"{sum(graphs.REPLAYS.values())} replays, "
          f"{sum(graphs.CAPTURES.values())} captures; {replay_ms:.2f} ms "
          f"an iteration replayed against "
          f"{eager_ms:.2f} eager (dispatches {[round(t, 1) for t in times]}"
          f" ms: warm-up, capture and replay, replays); {_card()}",
          flush=True)
    return tr, ref, dict(mode=tr.dispatch_mode, exact=exact, diffs=diffs,
                         launches_per_dispatch=per_dispatch, launches=path,
                         replay_ms=replay_ms, eager_ms=eager_ms)


def _graph_rollout_ms(tr, reps: int = 3) -> float:
    """Median host ms of the trainer's rollout alone (its results are
    dropped: after the comparison)."""
    return statistics.median(_timed(lambda: tr.rollout(
        tr.state.params, tr.env_state, tr.stats.reset_aggregates(),
        tr.draw, hidden=tr.hidden))[1] for _ in range(reps))


def _graph_clone_into(dst, src) -> None:
    """``dst`` (a trainer built alike) continues from where ``src`` is:
    its state (through a checkpoint), env state, statistics, buffer and
    generator."""
    import dataclasses

    from fsrl_torch.trainer.graphs import flatten
    from fsrl_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    path = ROOT / "logs" / "chip_smoke_graph_state.pt"
    save_checkpoint(str(path), src.state)
    load_checkpoint(str(path), dst.state)
    path.unlink()
    for name in ("env_state", "stats", "buf_state"):
        for x, y in zip(*(flatten(getattr(t, name))[0] for t in (dst, src))):
            x.copy_(y)
    dst.buf_state = dataclasses.replace(dst.buf_state,
                                        filled=src.buf_state.filled)
    dst.generator.set_state(src.generator.get_state())


def _graph_offpolicy(name: str) -> dict:
    """An off-policy path at the benchmark shape with ``update_chunk``
    256, against the eager cycle of a trainer with ``update_chunk`` 1 (no
    graph): ``fuse_iters`` 2 (one graph of 2 whole cycles), whose first
    dispatch is its eager warm-up; the eager trainer continues from there
    for the 2 cycles the second dispatch replays. The chunk graphs
    (``fuse_iters`` 1: two graphs, of 256 and 128 steps) after 2 collects
    against the fused trainer's warm-up. Then one replay of each graph
    timed alone, in ms a grad step."""
    from fsrl_torch.ops import kernels
    from fsrl_torch.trainer import OffpolicyTrainer

    def trainer(**kw):
        agent = _offpolicy_agent(name)
        return OffpolicyTrainer(agent.algo, agent.env, None, n_envs=OFF_ENVS,
                                steps_per_collect=OFF_T, buffer_size=100000,
                                update_per_step=OFF_UPS, cost_limit=10.0,
                                seed=0, verbose=False, state=agent.state,
                                **kw)

    fused = trainer(update_chunk=256, fuse_iters=GRAPH_FUSE_SHORT)
    chunked = trainer(update_chunk=256)
    ref = trainer(update_chunk=1)
    n_upd = ref.n_updates
    kernels.reset_launch_counts()
    warm_ms = _timed(fused._run_iter)[1]
    after_warm = {g: [v.clone() for v in t]
                  for g, t in _graph_groups(fused).items()}
    _graph_clone_into(ref, fused)
    eager = []
    for _ in range(GRAPH_FUSE_SHORT):
        ref.collect()
        eager.append(_timed(ref.update)[1] / n_upd)
    res = {}
    for label, tr, want, steps in (
            ("chunk 256", chunked, after_warm, chunked.chunk_sizes[0]),
            (f"fuse {GRAPH_FUSE_SHORT}", fused, _graph_groups(ref),
             GRAPH_FUSE_SHORT * n_upd)):
        times = [_timed(tr._run_iter)[1]
                 for _ in range(2 if tr is chunked else 1)]
        diffs, exact = _graph_diff(f"{name} {label}", _graph_groups(tr),
                                   want)
        graph = tr.graph or tr.chunk_graphs.get(steps)
        if graph is None or not graph.replays:
            fail(f"[graph {name} {label}] no graph was replayed "
                 f"({tr.dispatch_mode})")
            continue
        if tr is fused:
            _, ms = _timed(graph.captured.graph.replay)
            times.insert(0, warm_ms)
        else:
            _, ms = _timed(lambda: graph(tr.state, tr.buf_state, tr.view))
        res[label] = dict(mode=tr.dispatch_mode, exact=exact, diffs=diffs,
                          replay_ms_per_step=ms / steps,
                          eager_ms_per_step=statistics.median(eager))
        dispatches = [tr.graph] if tr.graph else tr.chunk_graphs.values()
        print(f"[graph {name} {label}] mode: {tr.dispatch_mode} "
              f"(reference: {ref.dispatch_mode}); chunk sizes "
              f"{tr.chunk_sizes}; largest differences {diffs} "
              f"({'bit for bit' if exact else 'NOT bit for bit'}); "
              f"{ms / steps:.3f} ms a grad step replayed ({steps} steps in "
              f"{ms:.1f} ms) against {statistics.median(eager):.3f} eager; "
              f"dispatches {[round(t, 1) for t in times]} ms (the eager "
              f"warm-up, then the capture and its replay); "
              f"{sum(d.captures for d in dispatches)} captures; {_card()}",
              flush=True)
    if sum(kernels.LAUNCHES.values()):
        fail(f"[graph {name}] a PPO kernel launched on an off-policy path: "
             f"{dict(kernels.LAUNCHES)}")
    return res


def phase_graphs() -> tuple:
    """The ``[graph ...]`` phases; returns the fused bf16 PPO-Lag trainer
    (profiled last) and the readings by path."""
    import torch
    from fsrl_torch.agent import (CPOAgent, PPOLagAgent,
                                  RecurrentPPOLagAgent, TRPOLagAgent)

    def ppo(dtype=None, hidden=(128, 128)):
        return lambda: PPOLagAgent(
            "SafetyCarCircle-v0", cost_limit=10.0, repeat=4, n_minibatches=8,
            compute_dtype=dtype, hidden_sizes=hidden)

    out = {}
    keep, _, out["ppo_lag_bf16_fuse8"] = _graph_onpolicy(
        "ppo_lag bf16 fuse 8", ppo(torch.bfloat16), fuse=GRAPH_FUSE)
    for key, tag, make, fuse, n in (
            ("ppo_lag_f32_fuse8", "ppo_lag f32 fuse 8", ppo(), GRAPH_FUSE, 4),
            ("ppo_lag_h256_f32_fuse2", "ppo_lag h256 f32 fuse 2",
             ppo(hidden=(256, 256)), GRAPH_FUSE_SHORT, 4),
            ("trpo_lag_fuse2", "trpo_lag fuse 2", lambda: TRPOLagAgent(
                "SafetyDroneRun-v0", cost_limit=10.0), GRAPH_FUSE_SHORT, 4),
            ("cpo_fuse2", "cpo fuse 2", lambda: CPOAgent(
                "SafetyAntRun-v0", cost_limit=10.0), GRAPH_FUSE_SHORT, 4),
            ("ppo_lag_rnn_fuse2", "ppo_lag_rnn fuse 2",
             lambda: RecurrentPPOLagAgent(NAV_TASK, cost_limit=10.0),
             GRAPH_FUSE_SHORT, 3)):
        out[key] = _graph_onpolicy(tag, make, fuse=fuse, dispatches=n)[2]
    tr, ref, r = _graph_onpolicy("ppo_lag bf16 unroll 8", ppo(torch.bfloat16),
                                 unroll=GRAPH_UNROLL)
    r.update(rollout_replay_ms=_graph_rollout_ms(tr),
             rollout_eager_ms=_graph_rollout_ms(ref))
    out["ppo_lag_bf16_unroll8"] = r
    print(f"[graph ppo_lag bf16 unroll 8] rollout of {T_STEPS} steps "
          f"{r['rollout_replay_ms']:.2f} ms in graphs of {GRAPH_UNROLL} "
          f"steps against {r['rollout_eager_ms']:.2f} eager; {_card()}",
          flush=True)
    # the recurrent update reads the carry at each segment's start, which
    # the rollout's graphs must leave as it was: 3 rollouts, the last two
    # from the carry the graphs wrote
    out["ppo_lag_rnn_unroll8"] = _graph_onpolicy(
        "ppo_lag_rnn unroll 8", lambda: RecurrentPPOLagAgent(
            NAV_TASK, cost_limit=10.0), unroll=GRAPH_UNROLL,
        dispatches=3)[2]
    for name in ("ddpg_lag", "sac_lag", "cvpo"):
        for label, r in _graph_offpolicy(name).items():
            out[f"{name}_{label.replace(' ', '')}"] = r
    return keep, out


def phase_graph_profile(tr) -> dict:
    """One dispatch of the fused bf16 PPO-Lag trainer, a replay of its
    graph, under ``torch.profiler`` (run last, as the breakdowns are): a
    replay runs no kernel wrapper, so the launch counters cannot show that
    K1 and K2 ran in it; the profiler's device events must hold each
    kernel ``fuse_iters`` times the eager cycle's count. Device busy share
    of the replay."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    replays = tr.graph.replays
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        _, wall_ms = _timed(tr._run_iter)
    if tr.graph.replays != replays + 1:
        fail("[graph profile] the dispatch did not replay its graph")
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    kernel = {"gae": "gae_kernel", "fused_ppo_grad": "ppo_grad_bf16_kernel"}
    seen = {k: sum(e.count for e in events if name in e.key)
            for k, name in kernel.items()}
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"[graph profile] one replay of {tr.fuse_iters} cycles: "
          f"{wall_ms:.2f} ms wall, device busy {busy_ms:.2f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), "
          f"{sum(e.count for e in events)} device ops; kernels seen {seen}"
          f" (launches a dispatch {dict(tr.graph.launches)}); {_card()}",
          flush=True)
    if seen != {k: tr.graph.launches[k] for k in kernel}:
        fail(f"[graph profile] the replay ran K1 / K2 {seen} times, the "
             f"capture launched {dict(tr.graph.launches)}")
    return dict(seen=seen, wall_ms=wall_ms, busy_ms=busy_ms)


# ---------------------------------------------------------------------------
# Data parallel: two ranks that share the card over gloo, spawned by this
# script (``python3 chip_smoke.py --dp-rank R W PORT LIBRARY OUT``), and the
# per-algorithm command lines
# ---------------------------------------------------------------------------

DP_WORLD = 2
DP_SEED = 3
# PPO-Lag's first iteration from a fresh trainer, held to one process at
# each of these seeds and at dp_blocks 2 (block-local) and 1 (the global
# shuffle: uneven, ragged shares)
DP_SEEDS = (3, 4, 5)
DP_BLOCKS = (2, 1)
DP_TIMEOUT = 600          # seconds both ranks may take for all DP phases
# (rtol, atol) for parameters after one data-parallel iteration against one
# process. f32: the CPU tests' (tests/test_torch_parallel.py). bf16: twice
# the largest of the six readings on an H100 80GB HBM3 at 700 W (7.774e-4
# at seed 4, dp_blocks 1), since the tests' bound failed there: K2's sums
# over each rank's rows, in another order than over the whole minibatch,
# move the bf16 run that far (the two ranks equal, bit for bit, one process
# whose K2 runs on each rank's rows, ``_shares``, checked below at both
# dp_blocks), and on that card one
# process moved 3.6e-5 from itself when every gradient entry moved one ulp
DP_TOL = {"f32": (2e-4, 2e-5), "bf16": (2e-4, 1.6e-3)}


def _dp_ppo_trainer(dtype, mesh=None, blocks: int = 2,
                    seed: int = DP_SEED):
    """PPO-Lag at the benchmark width with ``dp_blocks`` ``blocks``, its
    trainer data parallel over ``mesh`` (one process without)."""
    from fsrl_torch.agent import PPOLagAgent
    from fsrl_torch.trainer import OnpolicyTrainer
    agent = PPOLagAgent("SafetyCarCircle-v0", cost_limit=10.0, repeat=4,
                        n_minibatches=8, compute_dtype=dtype,
                        dp_blocks=blocks, seed=seed)
    return OnpolicyTrainer(agent.algo, agent.env, None, n_envs=N_ENVS,
                           steps_per_collect=T_STEPS, cost_limit=10.0,
                           seed=seed, verbose=False, mesh=mesh,
                           state=agent.state)


def _dp_cases():
    """The PPO-Lag cases held to one process: ``(key, form, dtype,
    dp_blocks, seed)``."""
    import torch
    return [(f"ppo_lag {form} b{blocks} s{seed}", form, dtype, blocks, seed)
            for form, dtype in (("f32", None), ("bf16", torch.bfloat16))
            for blocks in DP_BLOCKS for seed in DP_SEEDS]


def _dp_cpo_trainer(mesh=None):
    from fsrl_torch.agent import CPOAgent
    from fsrl_torch.trainer import OnpolicyTrainer
    agent = CPOAgent("SafetyAntRun-v0", cost_limit=10.0, seed=DP_SEED)
    return OnpolicyTrainer(agent.algo, agent.env, None, n_envs=N_ENVS,
                           steps_per_collect=T_STEPS, cost_limit=10.0,
                           seed=DP_SEED, verbose=False, mesh=mesh,
                           state=agent.state)


def _dp_sac_trainer(mesh=None):
    from fsrl_torch.trainer import OffpolicyTrainer
    agent = _offpolicy_agent("sac_lag", seed=DP_SEED)
    return OffpolicyTrainer(agent.algo, agent.env, None, cost_limit=10.0,
                            seed=DP_SEED, verbose=False, mesh=mesh,
                            state=agent.state, **OFF_LEARN)


def _flat(tr):
    """A copy of the trainer's flat parameters, on the CPU."""
    st = tr.state
    return (st.flat if hasattr(st, "flat") else st.params.flat).detach(
    ).cpu().clone()


def _dp_iteration(tr, dp):
    """One iteration of a rank's trainer with the launch counters zeroed
    before and read after: (host ms, launches, whether every rank holds the
    same parameters bit for bit)."""
    import torch
    from fsrl_torch.ops import kernels
    kernels.reset_launch_counts()
    _, ms = _timed(tr._run_iter)
    launches = dict(kernels.LAUNCHES)
    st = tr.state
    flat = st.flat if hasattr(st, "flat") else st.params.flat
    ref = flat.clone()
    dp.broadcast_(ref)
    return ms, launches, bool(torch.equal(ref, flat))


def _own_rows_rollout(tr):
    """``tr``'s rollout with the policy run on the rank's own rows (its
    noise still drawn for every env) in the place of the padded global
    batch the collector gives it: what the padding costs, and what it
    buys. The feedforward actor-critic's ``act_fn``."""
    import torch
    from fsrl_torch.data.collector import make_rollout_fn
    rows = tr.draw

    def act(params, obs, g):
        dist = params.actor(obs[rows.lo: rows.hi])
        noise = torch.randn((rows.n_total,) + dist.mean.shape[1:],
                            generator=g, device=obs.device)
        a = dist.sample(noise=noise[rows.lo: rows.hi])
        return rows.pad(a), rows.pad(dist.log_prob(a))

    return make_rollout_fn(tr.env, act, tr.T, tr.device)


def _collect_ms(tr, reps: int = 3) -> dict:
    """A rank's collect with the policy on the padded global batch (the
    path) and on its own rows, alternated: median ms of ``reps`` each.
    Advances the generator alike on every rank; the trainer's state is
    left as it was."""
    import torch
    variants = {"padded": tr.rollout, "own rows": _own_rows_rollout(tr)}
    times = {name: [] for name in variants}
    for _ in range(reps):
        for name, rollout in variants.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rollout(tr.state.params, tr.env_state,
                    tr.stats.reset_aggregates(), tr.draw)
            torch.cuda.synchronize()
            times[name].append(1e3 * (time.perf_counter() - t0))
    return {name: statistics.median(t) for name, t in times.items()}


def _policy_ms(tr, rows=(512, 1024, 2048, 4096), reps: int = 3) -> dict:
    """One process (f32): ms of a collect's ``T_STEPS`` policy calls at
    each env count, median of ``reps``: the padded forward at 4096 envs
    against a rank's own share at W = 8, 4, 2, 1."""
    import torch
    out = {}
    for n in rows:
        obs = tr.env_state.obs[:n].contiguous()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(T_STEPS):
                tr.algo.act_fn(tr.state.params, obs, tr.generator)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        out[n] = statistics.median(times)
    return out


def _shares(tr):
    """``tr`` (one process) with each grad step's K2 launched on the rows
    of its minibatch that each of ``DP_WORLD`` ranks owns (``owned_rows``:
    the rank's block of the envs, in the minibatch's order), and the
    results summed with the weights of the ranks' all-reduce (the rank's
    count over the minibatch's rows, in rank order): the data-parallel
    arithmetic in one process, at any ``dp_blocks`` (at 2 the shares are
    the minibatch's halves). Returns a function that runs one iteration
    so."""
    import torch

    import fsrl_torch.algos.ppo_lag as ppo_lag
    from fsrl_torch.types import owned_rows
    whole, index = ppo_lag.ppo_grad_minibatch, ppo_lag.minibatch_row_index
    seen = {}

    def rows_of(layout, *perms):
        rows = index(layout, *perms)
        n = layout.size // DP_WORLD
        seen["masks"] = [(rows >= r * n) & (rows < (r + 1) * n)
                         for r in range(DP_WORLD)]
        seen["counts"] = [owned_rows(rows, r * n, (r + 1) * n)[1]
                          for r in range(DP_WORLD)]
        seen["step"], seen["mb_rows"] = 0, layout.mb_rows
        return rows

    def shares(flat, layout, obs, act, logp_old, adv, ret, lam, resc, **kw):
        s = seen["step"]
        seen["step"] += 1
        terms = []
        for mask, counts in zip(seen["masks"], seen["counts"]):
            if counts[s] == 0:
                # no rows on this rank: it adds zeros, as the ranks do
                zero = torch.zeros((), device=flat.device)
                part = (zero, dict.fromkeys(ppo_lag.AUX_NAMES, zero),
                        torch.zeros_like(flat))
            else:
                m = mask[s]
                part = whole(flat, layout, obs[m], act[m], logp_old[m],
                             adv[m], ret[m], lam, resc, **kw)
            w = counts[s] / seen["mb_rows"]
            terms.append((part[0] * w, {k: v * w for k, v in
                                        part[1].items()}, part[2] * w))
        loss, aux, grad = terms[0]
        for l_r, a_r, g_r in terms[1:]:
            loss, grad = loss + l_r, grad + g_r
            aux = {k: aux[k] + a_r[k] for k in aux}
        return loss, aux, grad

    def run():
        ppo_lag.ppo_grad_minibatch = shares
        ppo_lag.minibatch_row_index = rows_of
        try:
            tr._run_iter()
        finally:
            ppo_lag.ppo_grad_minibatch = whole
            ppo_lag.minibatch_row_index = index

    return run


def _ulp_grads(tr):
    """``tr`` with every gradient entry moved up one ulp before each Adam
    step: the control for a last-bit difference of the sums."""
    import torch
    step = tr.algo.tx.update
    tr.algo.tx.update = lambda g, opt: step(
        torch.nextafter(g, torch.full_like(g, math.inf)), opt)
    return tr


def dp_rank_main(rank: int, world: int, port: str, library: str,
                 out: str) -> int:
    """One rank of the data-parallel phases: the process group over TCP
    (gloo: NCCL refuses two ranks on one card), the kernels loaded from the
    library the parent built, then PPO-Lag f32 and bf16 (every case of
    ``_dp_cases``; the first one a second iteration and the collect
    timed), CPO and SAC-Lag over the ranks; the results go to ``out``."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    from fsrl_torch.ops import kernels
    from fsrl_torch.parallel.mesh import (DPGroup, init_multihost,
                                          make_multihost_mesh)
    if not Path(library).exists():
        fail(f"[dp rank {rank}] the kernel library {library} is not built")
    init_multihost(f"localhost:{port}", world, rank, backend="gloo",
                   device="cuda:0")
    _print_modes(f" dp rank {rank}")
    mesh = make_multihost_mesh(device="cuda:0")
    dp = DPGroup.of(mesh)
    if kernels.build() != Path(library):
        fail(f"[dp rank {rank}] loaded another kernel library")
    kernels.library()
    res = {}
    for key, form, dtype, blocks, seed in _dp_cases():
        tr = _dp_ppo_trainer(dtype, mesh, blocks, seed)
        res[key] = [_dp_iteration(tr, dp)]
        res[f"{key} flat"] = _flat(tr)
        if (blocks, seed) == (2, DP_SEED):
            res[key].append(_dp_iteration(tr, dp))
            res[f"{key} metrics"] = tr.last_metrics
            res[f"ppo_lag {form} collect"] = _collect_ms(tr)
            own = _dp_ppo_trainer(dtype, mesh, blocks, seed)
            own.rollout = _own_rows_rollout(own)
            res[f"{key} own rows"] = _dp_iteration(own, dp)
            res[f"{key} own rows flat"] = _flat(own)
    tr = _dp_cpo_trainer(mesh)
    res["cpo"] = [_dp_iteration(tr, dp)]
    res["cpo flat"], res["cpo metrics"] = _flat(tr), tr.last_metrics
    tr = _dp_sac_trainer(mesh)
    res["sac_lag"] = [_dp_iteration(tr, dp)]
    res["sac_lag flat"] = _flat(tr)
    res["sac_lag buffer"] = {k: v[:OFF_T].cpu() for k, v in
                             vars(tr.buf_state.data).items()}
    res["sac_lag metrics"] = tr.last_metrics
    torch.save(res, out)
    dist.destroy_process_group()
    return 0


def _dp_one_process():
    """The one-process runs the ranks are held to: the first PPO-Lag
    iteration of every case of ``_dp_cases``, the CPO iteration and the
    SAC-Lag one, from the same seeds; the control: the first case of each
    form again with every gradient entry moved up one ulp before each Adam
    step; every case again with K2 on the rows each rank owns, summed as
    the ranks sum them (``_shares``); and the policy's forward at a rank's
    share of the rows."""
    import torch
    ref = {}
    for key, form, dtype, blocks, seed in _dp_cases():
        tr = _dp_ppo_trainer(dtype, None, blocks, seed)
        tr._run_iter()
        ref[key] = _flat(tr)
        if "policy ms" not in ref:
            ref["policy ms"] = _policy_ms(tr)
        tr = _dp_ppo_trainer(dtype, None, blocks, seed)
        _shares(tr)()
        ref[f"{key} shares"] = _flat(tr)
    for form, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        tr = _ulp_grads(_dp_ppo_trainer(dtype))
        tr._run_iter()
        ref[f"ppo_lag {form} ulp"] = _flat(tr)
    for name, make in (("cpo", _dp_cpo_trainer), ("sac_lag",
                                                  _dp_sac_trainer)):
        tr = make()
        tr._run_iter()
        ref[name], ref[f"{name} metrics"] = _flat(tr), tr.last_metrics
        if name == "sac_lag":
            ref["sac_lag buffer"] = {k: v[:OFF_T].cpu() for k, v in
                                     vars(tr.buf_state.data).items()}
    torch.cuda.synchronize()
    return ref


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_dp():
    """``[dp ppo_lag f32]``, ``[dp ppo_lag bf16]``, ``[dp cpo]``, ``[dp
    sac_lag]``: two ranks share the card over gloo. PPO-Lag at 4096 envs x
    64 steps global, repeat 4 x 8, ``dp_blocks`` 2 and 1 at each of
    ``DP_SEEDS`` from a fresh trainer: exactly 1 K1 and 32 K2 of the form
    on each rank every iteration, the ranks' parameters equal after each
    (the first case also after a second iteration), and after the first
    within ``DP_TOL`` of one process with the same seed, and equal bit for
    bit to one process whose K2 runs on the rows of each minibatch that
    each rank owns (``_shares``); beside them one process against
    itself with every gradient entry moved one ulp before each Adam step,
    two ranks with the policy on their own rows (not the path:
    ``_own_rows_rollout``), a rank's collect both ways, and the policy's
    forward at each rank's share of the rows. CPO (AntRun) one
    iteration: the ranks equal, the same ``optim_case``. SAC-Lag at the
    off-policy benchmark shape, one iteration of 640 grad steps: the ranks
    equal each other and the one-process run, buffers included, bit for
    bit. The ms and env-steps/s say what two ranks on one card cost, not a
    speed-up. Returns the launch counts by path."""
    import tempfile

    import torch
    from fsrl_torch.ops import kernels
    t0 = time.time()
    ref = _dp_one_process()
    print(f"[dp] the one-process runs in {time.time() - t0:.1f} s",
          flush=True)
    library = str(kernels.build())
    port = str(_free_port())
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(DP_WORLD)]
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--dp-rank",
             str(r), str(DP_WORLD), port, library, outs[r]], cwd=ROOT)
            for r in range(DP_WORLD)]
        t0 = time.time()
        for r, p in enumerate(procs):
            try:
                p.wait(timeout=max(1.0, DP_TIMEOUT - (time.time() - t0)))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                fail(f"[dp] the ranks ran past {DP_TIMEOUT} s")
        if any(p.returncode for p in procs):
            fail(f"[dp] a rank failed: exit codes "
                 f"{[p.returncode for p in procs]}")
        print(f"[dp] the two ranks ran in {time.time() - t0:.1f} s",
              flush=True)
        ranks = [torch.load(o) for o in outs]
    counts, far = {}, []
    forms = {"f32": "fused_ppo_grad_f32", "bf16": "fused_ppo_grad"}
    for key, form, _, blocks, seed in _dp_cases():
        tag = f"dp ppo_lag {form}"
        for r, res in enumerate(ranks):
            for i, (ms, launches, equal) in enumerate(res[key]):
                print(f"[{tag}] rank {r} seed {seed} dp_blocks {blocks} "
                      f"iteration {i}: {ms:.2f} ms, "
                      f"{N_ENVS * T_STEPS / (ms / 1e3):.0f} env-steps/s "
                      f"of the two ranks' envs; launches "
                      f"{launches}; ranks equal {equal}", flush=True)
                if (launches.get("gae", 0),
                        launches.get(forms[form], 0)) != (1, 32):
                    fail(f"[{tag}] rank {r} {key} iteration {i}: expected "
                         f"1 K1 and 32 {forms[form]} launches, got "
                         f"{launches}")
                if not equal:
                    fail(f"[{tag}] the ranks' parameters differ after "
                         f"{key} iteration {i}")
            if (blocks, seed) == (2, DP_SEED):
                counts[f"dp_ppo_lag_{form}_rank{r}"] = res[key][0][1]
        got, want = ranks[0][f"{key} flat"], ref[key]
        rtol, atol = DP_TOL[form]
        gap = float((got - want).abs().max())
        shares = ref[f"{key} shares"]
        same = torch.equal(got, shares)
        print(f"[{tag}] seed {seed} dp_blocks {blocks}, after one "
              f"iteration, 2 ranks against one process: largest parameter "
              f"distance {gap:.3e} (tolerance rtol {rtol}, atol {atol}); "
              f"against one process with K2 on each rank's rows, summed as "
              f"the ranks sum them: equal {same}, largest distance "
              f"{float((got - shares).abs().max()):.3e}", flush=True)
        if not torch.allclose(got, want, rtol=rtol, atol=atol):
            far.append(f"{key} by {gap:.3e}")
        if not same:
            far.append(f"{key}: 2 ranks against one process with K2 on "
                       f"each rank's rows")
    for form in forms:
        tag = f"dp ppo_lag {form}"
        first = f"ppo_lag {form} b2 s{DP_SEED}"
        ulp = float((ref[f"ppo_lag {form} ulp"] - ref[first]).abs().max())
        own = float((ranks[0][f"{first} own rows flat"]
                     - ref[first]).abs().max())
        print(f"[{tag}] seed {DP_SEED} dp_blocks 2, after one iteration: "
              f"the control, one process against itself with every "
              f"gradient entry moved one ulp before each Adam step, "
              f"largest parameter distance {ulp:.3e}; 2 ranks with the "
              f"policy on each rank's own rows (not the path) against one "
              f"process {own:.3e}, ranks equal "
              f"{[r[f'{first} own rows'][2] for r in ranks]}; last "
              f"metrics {ranks[0][f'{first} metrics']}", flush=True)
        for r, res in enumerate(ranks):
            c = res[f"ppo_lag {form} collect"]
            print(f"[{tag}] rank {r} collect of its {N_ENVS // DP_WORLD} "
                  f"envs x {T_STEPS} steps, median of 3: the policy on the "
                  f"padded global batch {c['padded']:.2f} ms, on its own "
                  f"rows {c['own rows']:.2f} ms", flush=True)
    print(f"[dp policy forward] one process, {T_STEPS} policy calls (a "
          f"collect's) at 4096 envs and at a rank's share for W 2, 4, 8: "
          + ", ".join(f"{n} envs {ms:.3f} ms" for n, ms in sorted(
              ref["policy ms"].items(), reverse=True)), flush=True)
    cases = [r["cpo metrics"]["loss/optim_case"] for r in ranks]
    ms = ranks[0]["cpo"][0][0]
    cpo_dist = float((ranks[0]["cpo flat"] - ref["cpo"]).abs().max())
    print(f"[dp cpo] SafetyAntRun-v0, one iteration: {ms:.2f} ms on rank "
          f"0; "
          f"ranks equal {[r['cpo'][0][2] for r in ranks]}; optim_case "
          f"{cases} (one process {ref['cpo metrics']['loss/optim_case']}); "
          f"distance to one process {cpo_dist:.3e}; launches "
          f"{ranks[0]['cpo'][0][1]}", flush=True)
    if not all(r["cpo"][0][2] for r in ranks) or len(set(cases)) != 1:
        fail(f"[dp cpo] the ranks differ: optim_case {cases}")
    counts["dp_cpo_rank0"] = ranks[0]["cpo"][0][1]
    sac_equal = all(torch.equal(r["sac_lag flat"], ref["sac_lag"])
                    for r in ranks)
    per = OFF_ENVS // DP_WORLD
    buf_equal = all(torch.equal(v, ref["sac_lag buffer"][k][:, r * per:
                                                           (r + 1) * per])
                    for r, res in enumerate(ranks)
                    for k, v in res["sac_lag buffer"].items())
    ms = ranks[0]["sac_lag"][0][0]
    print(f"[dp sac_lag] {OFF_TASK}, {OFF_ENVS} envs x {OFF_T} steps, "
          f"{round(OFF_UPS * OFF_ENVS * OFF_T)} grad steps: {ms:.2f} ms on "
          f"rank 0 ({ms / round(OFF_UPS * OFF_ENVS * OFF_T):.3f} ms per "
          f"grad step); ranks equal {[r['sac_lag'][0][2] for r in ranks]}; "
          f"parameters equal to one process {sac_equal}, buffers "
          f"{buf_equal}", flush=True)
    if not (sac_equal and buf_equal
            and all(r["sac_lag"][0][2] for r in ranks)):
        fail("[dp sac_lag] the ranks differ from one process")
    if far:
        fail(f"[dp ppo_lag] 2 ranks differ from one process: {far}")
    return counts


def _cli(runs: dict, timeout: float = 300) -> dict:
    """Run command lines of the port at once (``{tag: argv}``): they are
    correctness checks, and run side by side they take the time of one.
    Returns each one's standard output; fails on a non-zero exit."""
    t0 = time.time()
    procs = {tag: subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True)
             for tag, cmd in runs.items()}
    outs = {}
    for tag, p in procs.items():
        try:
            out, err = p.communicate(
                timeout=max(1.0, timeout - (time.time() - t0)))
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            fail(f"[{tag}] ran past {timeout} s")
        tail = (out + err).strip().splitlines()[-4:]
        print(f"[{tag}] {' '.join(runs[tag][1:])}: exit {p.returncode} at "
              f"{time.time() - t0:.1f} s; {' | '.join(tail)}", flush=True)
        if p.returncode != 0:
            fail(f"[{tag}] failed:\n{out[-3000:]}\n{err[-3000:]}")
        outs[tag] = out
    return outs


def phase_cli():
    """``[cli ppol]``: ``python -m
    fsrl_torch.examples.mlp.train_ppol_agent`` for one epoch of one
    collect at its defaults otherwise (20 envs x 500 steps, f32), then
    ``eval_ppol_agent --path`` on its run directory;
    ``[cli ppol mesh]``: the same under ``torchrun --nproc_per_node 1`` with
    ``--use_mesh true`` (NCCL, one rank). The two run side by side."""
    import shutil
    logs = ROOT / "logs" / "chip_smoke_cli"
    shutil.rmtree(logs, ignore_errors=True)
    train = ["-m", "fsrl_torch.examples.mlp.train_ppol_agent", "--epochs",
             "1", "--step_per_epoch", "10000", "--verbose", "false"]
    launchers = {
        "cli ppol": ([sys.executable], []),
        "cli ppol mesh": ([sys.executable, "-m", "torch.distributed.run",
                           "--nproc_per_node", "1", "--master_port",
                           str(_free_port())], ["--use_mesh", "true"])}
    logdirs = {tag: logs / tag.replace(" ", "_") for tag in launchers}
    outs = _cli({tag: launcher + train + extra + ["--logdir",
                                                  str(logdirs[tag])]
                 for tag, (launcher, extra) in launchers.items()})
    evals = {}
    for tag, out in outs.items():
        runs = sorted(p for p in logdirs[tag].glob("*/*/*") if p.is_dir())
        if "final eval" not in out or len(runs) != 1 or not (
                runs[0] / "checkpoint" / "model_best.pt").is_file():
            fail(f"[{tag}] no run directory with a checkpoint: {runs}")
        evals[f"{tag} eval"] = [
            sys.executable, "-m", "fsrl_torch.examples.mlp.eval_ppol_agent",
            "--path", str(runs[0]), "--eval_episodes", "10"]
    for tag, out in _cli(evals).items():
        if "Eval reward" not in out:
            fail(f"[{tag}] printed no result")
    shutil.rmtree(logs, ignore_errors=True)


# ---------------------------------------------------------------------------
# the training-quality entry points: the learning-curve runner, the
# hand-assembled loops, and the agent gates too long for the CPU tests
# ---------------------------------------------------------------------------

# the JAX runner's committed result whose keys the port's runner writes
CURVES_REF = ROOT / "benchmarks" / "results_1m" / "SafetyBallCircle-v0-sacl-s0.json"


def _ppo_k2_name(env) -> str:
    """The K2 form and dtype PPO-Lag's default recipe (f32, hidden (128,
    128)) launches on ``env``."""
    from fsrl_torch.ops.fused_ppo_grad import GradLayout, launch_name
    return launch_name(GradLayout(D=env.observation_size, H=128,
                                  A=env.action_size, K=1 + env.num_costs),
                       bf16=False)


def _counted(fn):
    """``fn()``, its host seconds and the kernel launches it made."""
    from fsrl_torch.ops import kernels
    kernels.reset_launch_counts()
    t0 = time.time()
    out = fn()
    return out, time.time() - t0, dict(kernels.LAUNCHES)


def phase_curves() -> dict:
    """``[curves]``: the port's learning-curve runner
    (``fsrl_torch.examples.run_curves``) on the card at its defaults: one
    epoch of ``ppol`` on SafetyCarCircle-v0 (20 envs x 500 steps, one
    collect) and two of ``sacl`` on SafetyBallCircle-v0 (8 envs x 125
    steps; an epoch is one dispatch of ten collects of 200 grad steps, the
    first the eager warm-up, the second the capture of their graph and its
    replay). Its JSON keys are those of the JAX runner's committed result
    (``CURVES_REF``), the summary table lists both, the ``ppol`` run
    launches K1 and the K2 form ``kernel_form`` picks, the ``sacl`` run
    none and replays its graph of 10 cycles. Returns the launches by
    run."""
    import shutil

    from fsrl_torch.envs import make
    from fsrl_torch.examples import run_curves
    from fsrl_torch.trainer import graphs
    outdir = ROOT / "logs" / "chip_smoke_curves"
    shutil.rmtree(outdir, ignore_errors=True)
    with open(CURVES_REF) as f:
        ref_keys = set(json.load(f))
    counts = {}
    for key, task, budget, epochs in (
            ("ppol", "SafetyCarCircle-v0", "--budget", 1),
            ("sacl", "SafetyBallCircle-v0", "--off_budget", 2)):
        graphs.CAPTURES.clear()
        graphs.REPLAYS.clear()
        (row,), secs, launches = _counted(lambda: run_curves.main([
            "--task", task, "--algos", key, "--seeds", "0", budget,
            str(10000 * epochs), "--outdir", str(outdir)]))
        path = outdir / f"{task}-{key}-s0.json"
        with open(path) as f:
            keys = set(json.load(f))
        summary = outdir / f"summary-{task}.md"
        print(f"[curves {key}] {task}, {epochs} epochs of 10,000 env "
              f"steps: {secs:.1f} s, reward {row['final_reward']:.2f} cost "
              f"{row['final_cost']:.2f}, best {row['best_reward']:.2f} / "
              f"{row['best_cost']:.2f}, {row['steps_per_s']:.0f} env-steps/s"
              f"; launches {launches}; graph captures "
              f"{dict(graphs.CAPTURES)}, replays {dict(graphs.REPLAYS)}; "
              f"keys as the JAX runner's {keys == ref_keys}", flush=True)
        if keys != ref_keys:
            fail(f"[curves {key}] keys {sorted(keys ^ ref_keys)} differ "
                 f"from {CURVES_REF.name}'s")
        if not all(math.isfinite(row[k]) for k in (
                "final_reward", "final_cost", "best_reward", "best_cost")) \
                or len(row["curve"]["reward"]) != epochs:
            fail(f"[curves {key}] a result is not finite or the curve is "
                 f"not {epochs} epochs: {row}")
        if not summary.is_file() or f"| {key} | 0 |" not in \
                summary.read_text():
            fail(f"[curves {key}] the summary {summary} lacks the run")
        if key == "ppol":
            k2 = _ppo_k2_name(make(task))
            if set(launches) != {"gae", k2} or launches["gae"] != 1 or \
                    launches[k2] != 16:
                fail(f"[curves ppol] expected 1 K1 and 16 {k2} launches, "
                     f"got {launches}")
        elif launches:
            fail(f"[curves sacl] the off-policy path launched {launches}")
        elif (dict(graphs.CAPTURES), dict(graphs.REPLAYS)) != (
                {"10 cycles": 1}, {"10 cycles": 1}):
            fail("[curves sacl] expected one capture and one replay of the "
                 "graph of 10 cycles")
        counts[f"curves_{key}"] = launches
    shutil.rmtree(outdir, ignore_errors=True)
    return counts


def phase_customized() -> dict:
    """``[customized]``: the hand-assembled loops on the card.
    ``train_ppol`` for 2 iterations at its defaults otherwise (32 envs x
    300 steps, repeat 4 x 4: 2 K1 and 32 K2 launches of the form), then
    ``eval_ppol``'s command line on its run directory, whose evaluation
    must equal the trained state's bit for bit at the same seed;
    ``collect_dataset`` for 2 epochs of one collect (20 envs x 500 steps,
    the limit swept from 10 to 80: 2 K1 launches), whose HDF5 file must
    read back with the dataset's keys, dtypes and shapes. Returns the
    launches by script."""
    import shutil

    import numpy as np

    from fsrl_torch.data.traj_buf import KEYS, TrajectoryBuffer
    from fsrl_torch.envs import make
    from fsrl_torch.examples.customized import (collect_dataset, eval_ppol,
                                                train_ppol)
    from fsrl_torch.examples.customized.custom_common import (
        eval_main, evaluate_policy)
    logs = ROOT / "logs" / "chip_smoke_customized"
    shutil.rmtree(logs, ignore_errors=True)
    counts = {}
    (run_dir, state), secs, launches = _counted(lambda: train_ppol.main([
        "--total_iters", "2", "--eval_every", "1", "--logdir", str(logs)]))
    env = make("SafetyCarCircle-v0")
    k2 = _ppo_k2_name(env)
    trained = evaluate_policy(env, eval_ppol.build(
        env, {"cost_limit": 10.0}, "cuda"), state.params, 10, seed=0)
    reloaded = eval_main(eval_ppol.build, ["--path", run_dir])
    print(f"[customized train_ppol] 2 iterations of 32 envs x 300 steps: "
          f"{secs:.1f} s, launches {launches}; the trained state's "
          f"evaluation {trained}, eval_ppol's {reloaded}", flush=True)
    if launches != {"gae": 2, k2: 32}:
        fail(f"[customized train_ppol] expected 2 K1 and 32 {k2} "
             f"launches, got {launches}")
    if trained != reloaded or not all(map(math.isfinite, trained)):
        fail(f"[customized eval_ppol] the reloaded policy's evaluation "
             f"{reloaded} differs from the trained one's {trained}")
    counts["customized_train_ppol"] = launches
    (path, limits), secs, launches = _counted(lambda: collect_dataset.main([
        "--epochs", "2", "--iters_per_epoch", "1", "--logdir",
        str(logs / "datasets")]))
    data = TrajectoryBuffer.load(path)
    n = len(data["rewards"])
    env = make("SafetyBallCircle-v0")
    shapes = {"observations": (n, env.observation_size),
              "next_observations": (n, env.observation_size),
              "actions": (n, env.action_size), "rewards": (n,),
              "costs": (n,), "terminals": (n,), "timeouts": (n,)}
    dtypes = {k: (np.bool_ if k in ("terminals", "timeouts")
                  else np.float32) for k in KEYS}
    print(f"[customized collect_dataset] 2 epochs of 20 envs x 500 steps, "
          f"limits {limits}: {secs:.1f} s, launches {launches}; {path}: "
          + ", ".join(f"{k} {v.dtype} {v.shape}" for k, v in data.items()),
          flush=True)
    if set(data) != set(KEYS) or n == 0 or any(
            data[k].shape != shapes[k] or data[k].dtype != dtypes[k]
            for k in KEYS) or not all(
            np.isfinite(data[k]).all() for k in KEYS):
        fail(f"[customized collect_dataset] the dataset read back is not "
             f"the dataset's layout: "
             f"{ {k: (v.dtype, v.shape) for k, v in data.items()} }")
    if limits != [10.0, 80.0] or launches != {"gae": 2}:
        fail(f"[customized collect_dataset] limits {limits}, launches "
             f"{launches}: expected [10.0, 80.0] and 2 K1")
    counts["customized_collect_dataset"] = launches
    shutil.rmtree(logs, ignore_errors=True)
    return counts


def phase_gates_offpolicy() -> dict:
    """``[gates offpolicy]``: the agent gate of ``tests/test_all_agents.py``
    too long for the CPU tests (about 350 s there), on the card with its
    task, budget, seed and thresholds: CVPO on SafetyBallRun-v0 at a cost
    limit of 25, 8 epochs of 5,000 env steps (4 envs x 100 steps, 80 grad
    steps a collect); the feasibility-first best test result has reward
    above 80 and cost within 1.2x the limit, and the final state holds the
    constraint by the final test or by the PID controller's EMA of the
    realized cost (within 2x the limit). No kernel launches. Returns the
    launches."""
    from fsrl_torch.agent import CVPOAgent
    limit = 25.0
    agent = CVPOAgent("SafetyBallRun-v0", cost_limit=limit, seed=0)
    info, secs, launches = _counted(lambda: agent.learn(
        epochs=8, step_per_epoch=5000, n_envs=4, steps_per_collect=100,
        episode_per_test=10, buffer_size=50000, update_per_step=0.2,
        verbose=False))
    ema = float(agent.state.lag.cost_ema.sum())
    print(f"[gates offpolicy cvpo constrained] SafetyBallRun-v0: "
          f"{secs:.1f} s; best reward {info['best_reward']:.2f} cost "
          f"{info['best_cost']:.2f}; final test cost {info['test_cost']:.2f}"
          f", cost EMA {ema:.2f}; launches {launches}", flush=True)
    if not info["best_reward"] > 80.0:
        fail(f"[gates offpolicy] CVPO did not learn: {info}")
    if not info["best_cost"] <= 1.2 * limit:
        fail(f"[gates offpolicy] CVPO's best is infeasible: {info}")
    if not (info["test_cost"] <= 2.0 * limit or ema <= 2.0 * limit):
        fail(f"[gates offpolicy] CVPO's final state diverged: final test "
             f"cost {info['test_cost']:.1f}, EMA {ema:.1f}: {info}")
    if launches:
        fail(f"[gates offpolicy] the off-policy path launched {launches}")
    return {"gates_cvpo_constrained": launches}


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available: the port runs on the GPU only")
    if not (ROOT / "fsrl_torch" / "csrc").is_dir():
        fail(f"the fsrl_torch sources are not beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    from fsrl_torch.agent import FOCOPSAgent
    from fsrl_torch.ops import kernels as fsrl_kernels
    t_start = time.time()
    _print_modes()

    def mark(tag):
        print(f"[time] {tag} done at {time.time() - t_start:.1f} s",
              flush=True)

    ptxas = phase_build()
    # host-clock timings first: once torch.profiler has run in a process,
    # every later launch costs the host more
    phase_critic_forms()
    mark("critic forms")
    launches, ppo_trainer = phase_train()
    mark("ppo_lag")
    k2_f32_launches = phase_train_ppo_f32()
    gae_by_path, f32_agents = phase_new_paths()
    mark("on-policy paths")
    nav_counts = phase_train_nav()
    rnn_counts = phase_train_rnn()
    mark("navigation paths")
    # K2's generic form on the main path at other hidden widths
    width_runs = {**phase_train_width((256, 256)),
                  **phase_train_width((64, 64), dtypes=(None,))}
    mark("width paths")
    host = phase_train_host()
    # the velocity suite's widest tasks, above K2's old envelope: one epoch
    # each of Ant and Humanoid, then the host command line at Humanoid's
    # widths
    host_ant = phase_train_host(task="SafetyAntVelocity-v1", name="ant",
                                iters=0)
    host_hum = phase_train_host(task="SafetyHumanoidVelocity-v1",
                                name="humanoid", iters=0)
    # above 32 actions: the generic form on the host path
    host_a40 = phase_train_host(task=HOST_A40, tag_name="a40")
    host_cli = phase_train_host_cli()
    host_sac = phase_train_host_sac()
    phase_host_real()
    phase_grid_filter()
    mark("host paths")
    phase_update_parity()
    phase_update_parity_nav()
    phase_update_parity_widths()
    mark("update parity")
    phase_checkpoint(
        f32_agents["focops"], lambda: FOCOPSAgent(
            "SafetyCarCircle-v0", cost_limit=10.0, seed=11, repeat=4,
            n_minibatches=8), "checkpoint",
        dict(epochs=1, step_per_epoch=N_ENVS * T_STEPS, n_envs=N_ENVS,
             steps_per_collect=T_STEPS, episode_per_test=2))
    sac_agent = phase_offpolicy()
    mark("off-policy paths")
    graph_tr, graphs = phase_graphs()
    mark("graphs")
    dp_counts = phase_dp()
    mark("data parallel")
    phase_cli()
    mark("command lines")
    entry_counts = {**phase_curves(), **phase_customized(),
                    **phase_gates_offpolicy()}
    mark("curves, customized loops, off-policy gates")
    k1 = phase_gae()
    k2 = _k2_case(2, True)
    phase_k2_scaling(k2["ms"], bf16=True)
    _k2_case(3, True)
    k2_f32 = _k2_case(2, False)
    phase_k2_scaling(k2_f32["ms"], bf16=False)
    # the main path's instances, unchanged by the wider action envelope
    # (their readings before it, on the same card model and power limit)
    print(f"[K2 D 9] bf16 {k2['ms']:.4f} ms (before: 0.0679), f32 "
          f"{k2_f32['ms']:.4f} ms (before: 0.3142)", flush=True)
    # the host path's shape (D 17, A 6) at its 256-row minibatch and at
    # the main path's 32,768 rows
    host_k2 = {(B, bf16): _k2_case(2, bf16, B=B, D=17, A=6)
               for B in (256, 32768) for bf16 in (True, False)}
    wide = {(D, bf16): _k2_case(2, bf16, D=D) for D in (21, 54)
            for bf16 in (True, False)}
    phase_k2_f32_natural_rows()
    for D in (21, 54):
        phase_k2_f32_natural_rows(seeds=(0,), D=D)
    phase_k2_edges()
    autograd_ms = phase_autograd()
    # the velocity suite's widest tasks: Ant (105, 8) and Humanoid
    # (348, 17), at the host path's 256 rows and at 32,768; the f32 kernel
    # on Humanoid's natural rows against float64, with its retakes; the
    # autograd step those widths took before this kernel
    vel_k2 = {(D, A, B, bf16): _k2_case(2, bf16, B=B, D=D, A=A)
              for D, A in ((105, 8), (348, 17)) for B in (256, 32768)
              for bf16 in (True, False)}
    retakes = phase_k2_f32_natural_rows(seeds=(0,), D=348, A=17)
    autograd_hum = {B: phase_autograd(B, 348, 17, "humanoid")
                    for B in (256, 32768)}
    # the generic form at its cases, and the autograd step the hidden
    # (256, 256) path ran before it
    k2_any = phase_k2_any()
    any_split = phase_k2_any_split(k2_any)
    # the generic f32 form on natural rows at hidden (256, 256), with its
    # float64 retakes
    any_retakes = phase_k2_f32_natural_rows(hidden=(256, 256))
    autograd_h256 = phase_autograd(32768, 9, 2, "h256", hidden=(256, 256))
    lib = fsrl_kernels.library()
    for (D, A, B, bf16), r in vel_k2.items():
        key = k2_instance(D, A, bf16)
        r["smem_bytes"] = lib.fsrl_ppo_grad_smem_bytes(D, A, 2, int(bf16))
        r["registers"] = ptxas.get(key, (None,))[0]
        # the block partials and aux rows the reduce launch sums
        part = 4 * lib.fsrl_ppo_grad_scratch_floats(B, D, 128, A, 2)
        print(f"[K2 B={B} D={D} A={A} K=2 {'bf16' if bf16 else 'f32'}] "
              f"instance {key}: {r['registers']} registers, "
              f"{r['smem_bytes']} bytes of shared memory, {part} bytes of "
              f"block partials", flush=True)
    mark("kernels")
    phase_breakdown(ppo_trainer)
    for name, agent in f32_agents.items():
        phase_breakdown(agent.trainer, tag=f"breakdown {name}")
    mark("on-policy breakdowns")
    phase_offpolicy_breakdown(sac_agent)
    mark("sac_lag breakdown")
    graph_profile = phase_graph_profile(graph_tr)
    mark("graph profile")
    graph_launches = lambda name: {
        f"graph_{path}": r["launches"].get(name, 0)
        for path, r in graphs.items() if r.get("launches", {}).get(name)}

    nav_f32, nav_bf16 = (nav_counts[f"train ppo_lag nav {t}"]
                         for t in ("f32", "bf16"))
    host_f32, host_bf16 = (host[f"train host ppo_lag {t}"]["launches"]
                           for t in ("f32", "bf16"))
    wide_hosts = {name: {t: out[f"train host ppo_lag {name} {t}"]["launches"]
                         for t in ("f32", "bf16")}
                  for name, out in (("ant", host_ant), ("humanoid", host_hum))}
    vel_ms = lambda bf16: {
        f"B{B}_D{D}_A{A}": {k: vel_k2[D, A, B, bf16][k] for k in
                            ("ms", "bound_ms", "plain_ms", "smem_bytes",
                             "registers")}
        for D, A in ((105, 8), (348, 17)) for B in (256, 32768)}
    wide_launches = lambda form, t: {
        f"host_ppo_lag_{name}_{t}": wide_hosts[name][t].get(form, 0)
        for name in ("ant", "humanoid")}
    host_ms = lambda bf16: {f"B{B}_D17_A6": {k: host_k2[B, bf16][k] for k in
                                             ("ms", "bound_ms", "plain_ms")}
                            for B in (256, 32768)}
    wide_ms = lambda bf16: {f"D{D}": {k: wide[D, bf16][k] for k in
                                      ("ms", "bound_ms", "plain_ms")}
                            for D in (21, 54)}
    def any_entry(bf16):
        t = "bf16" if bf16 else "f32"
        name = "fused_ppo_grad_any" if bf16 else "fused_ppo_grad_any_f32"
        main = k2_any[9, 256, 256, 2, 32768, bf16]
        h64 = width_runs.get(f"train ppo_lag h64 {t}")
        return dict(
            name=name, route="cuda",
            source="fsrl_torch/csrc/fused_ppo_grad_any.cu",
            replaces="fsrl_tpu/ops/fused_ppo_grad.py:68",
            launches=width_runs[f"train ppo_lag h256 {t}"]["launches"].get(
                name, 0), library_ms=None,
            launches_by_path={
                f"ppo_lag_h256_{t}": width_runs[f"train ppo_lag h256 {t}"][
                    "launches"].get(name, 0),
                **({f"ppo_lag_h64_{t}": h64["launches"].get(name, 0)}
                   if h64 else {}),
                f"host_ppo_lag_a40_{t}": host_a40[f"train host a40 {t}"][
                    "launches"].get(name, 0),
                **graph_launches(name)},
            by_case={f"B{B}_D{D}_H{H1}x{H2}_A{A}": {
                **{k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "max_abs_err")},
                **({"launch_ms": any_split[D, H1, H2, A, B, b]}
                   if (D, H1, H2, A, B, b) in any_split else {})}
                for (D, H1, H2, A, B, b), r in k2_any.items() if b == bf16},
            **({} if bf16 else {
                "retakes_h256_natural_rows": list(any_retakes)}),
            autograd_step_ms_h256=autograd_h256,
            **{k: main[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by")})

    kernels = [
        dict(name="gae", route="cuda", source="fsrl_torch/csrc/gae.cu",
             replaces="fsrl_tpu/ops/pallas_gae.py:27",
             launches=launches.get("gae", 0), library_ms=None,
             launches_by_path=dict(
                 ppo_lag_bf16=launches.get("gae", 0), **gae_by_path,
                 ppo_lag_nav_f32=nav_f32.get("gae", 0),
                 ppo_lag_nav_bf16=nav_bf16.get("gae", 0),
                 ppo_lag_rnn=rnn_counts.get("gae", 0),
                 host_ppo_lag_f32=host_f32.get("gae", 0),
                 host_ppo_lag_bf16=host_bf16.get("gae", 0),
                 **wide_launches("gae", "f32"),
                 **wide_launches("gae", "bf16"),
                 host_cli=host_cli["launches"].get("gae", 0),
                 **{k.replace("train ", "").replace(" ", "_"):
                    v["launches"].get("gae", 0)
                    for k, v in width_runs.items()},
                 **{f"host_ppo_lag_a40_{t}":
                    host_a40[f"train host a40 {t}"]["launches"].get("gae", 0)
                    for t in ("f32", "bf16")},
                 host_sac_lag=host_sac["launches"].get("gae", 0),
                 **{f"{k}_per_iteration": v.get("gae", 0)
                    for k, v in dp_counts.items()},
                 **{k: v.get("gae", 0) for k, v in entry_counts.items()},
                 **graph_launches("gae")),
             graphs=graphs, graph_profile=graph_profile,
             **k1),
        dict(name="fused_ppo_grad", route="cuda",
             source="fsrl_torch/csrc/fused_ppo_grad.cu",
             replaces="fsrl_tpu/ops/fused_ppo_grad.py:68",
             launches=launches.get("fused_ppo_grad", 0), library_ms=None,
             launches_by_path=dict(
                 ppo_lag_bf16=launches.get("fused_ppo_grad", 0),
                 ppo_lag_nav_bf16=nav_bf16.get("fused_ppo_grad", 0),
                 host_ppo_lag_bf16=host_bf16.get("fused_ppo_grad", 0),
                 **wide_launches("fused_ppo_grad", "bf16"),
                 **{f"{k}_per_iteration": v.get("fused_ppo_grad", 0)
                    for k, v in dp_counts.items() if "bf16" in k},
                 **graph_launches("fused_ppo_grad")),
             by_width=wide_ms(True), host_path=host_ms(True),
             velocity_widest=vel_ms(True), **k2),
        dict(name="fused_ppo_grad_f32", route="cuda",
             source="fsrl_torch/csrc/fused_ppo_grad_f32.cu",
             replaces="fsrl_tpu/ops/fused_ppo_grad.py:68",
             launches=k2_f32_launches, library_ms=None,
             launches_by_path=dict(
                 ppo_lag_f32=k2_f32_launches,
                 ppo_lag_nav_f32=nav_f32.get("fused_ppo_grad_f32", 0),
                 host_ppo_lag_f32=host_f32.get("fused_ppo_grad_f32", 0),
                 **wide_launches("fused_ppo_grad_f32", "f32"),
                 host_cli=host_cli["launches"].get("fused_ppo_grad_f32", 0),
                 **{f"{k}_per_iteration": v.get("fused_ppo_grad_f32", 0)
                    for k, v in dp_counts.items() if "f32" in k},
                 **{k: v.get("fused_ppo_grad_f32", 0)
                    for k, v in entry_counts.items()},
                 **graph_launches("fused_ppo_grad_f32")),
             by_width=wide_ms(False), host_path=host_ms(False),
             velocity_widest=vel_ms(False),
             retakes_d348_natural_rows=list(retakes),
             autograd_step_ms_d21=autograd_ms,
             autograd_step_ms_humanoid={f"B{B}": v
                                        for B, v in autograd_hum.items()},
             **k2_f32),
        any_entry(True),
        any_entry(False),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ------------------------------------------------ readings of the generic K2
# Readings of K2's generic form that PERF.md compares with another tree's
# form (not run by main()):
#   python3 chip_smoke.py --k2-any-readings times <label>
#   python3 chip_smoke.py --k2-any-readings bf16 <file> [--against]
#   python3 chip_smoke.py --k2-any-readings host <label>
# To read another tree (a git archive of a parent commit), copy this script
# into its root under another name and run it there: it imports the
# fsrl_torch beside it.

def reading_times(label: str):
    """The three timed shapes of ``K2_ANY_CASES`` in both dtypes on rows
    clear of the kinks (``_k2_case``), then f32 at the host minibatch on
    natural rows: its time and its float64 retakes a launch."""
    from fsrl_torch.ops import fused_ppo_grad as fpg
    for bf16 in (True, False):
        for D, H1, H2, A, K, B, timed in K2_ANY_CASES:
            if timed:
                r = _k2_case(K, bf16, B=B, D=D, A=A, hidden=(H1, H2))
                print(f"[reading {label}] ({D}, {H1}, {H2}, {A}, {K}, {B}) "
                      f"{'bf16' if bf16 else 'f32'} ms {r['ms']:.4f}",
                      flush=True)
    kw = dict(eps_clip=0.2, vf_coef=0.25, bf16=False)
    for seed in (0, 1):
        args = _k2_inputs(2, False, 256, 348, 40, off_kinks=False, seed=seed,
                          hidden=(128, 128))
        try:
            fpg.retake_counts("any")
            fpg.ppo_grad_rows(*args, **kw)
            retakes = fpg.retake_counts("any")
        except TypeError:   # a form without float64 retakes
            retakes = None
        ms = time_ms(lambda: fpg.ppo_grad_rows(*args, **kw))
        print(f"[reading {label}] (348, 128, 128, 40, 2, 256) f32 natural "
              f"rows seed {seed} ms {ms:.4f}, retakes a launch {retakes}",
              flush=True)


def _plain64_bf16(args, **kw):
    """The bf16 plain version in float64: the same operands rounded to
    bf16, every product and sum in float64."""
    import torch
    from fsrl_torch.ops import fused_ppo_grad as fpg
    keep = fpg._bf
    fpg._bf = lambda x, bf16: x.to(torch.bfloat16).to(x.dtype) if bf16 else x
    try:
        return _plain64(args, **kw)
    finally:
        fpg._bf = keep


def reading_bf16(path: str, against: bool = False):
    """The bf16 form at (348, 128, 128, 40, 2, 32768), where its error is
    largest: each tensor's error against the plain version and against the
    float64 evaluation of the bf16 function, on natural rows and on rows
    drawn clear of the (unrounded) kinks; then, from the form's scratch, the
    entries of h1 whose bf16 value differs from the plain version's and the
    float64 evaluation's, and the ReLU sides of h2 (g_h2 != 0) that differ
    from float64's. Saves the inputs and gradients to ``path``; with
    ``against``, reads them and holds this tree's form to them instead."""
    import torch
    from fsrl_torch.ops import fused_ppo_grad as fpg, kernels
    kw = dict(eps_clip=0.2, vf_coef=0.25, bf16=True)
    D, A, K, B, H = 348, 40, 2, 32768, 128
    if against:
        d = torch.load(path, weights_only=False)
        g, _ = fpg.ppo_grad_rows(*d["args"], **kw)
        for ref in ("plain", "float64", "kernel"):
            e = _tensor_errs(d["args"][1], g, d[ref].to(g.device))
            print(f"[reading bf16] this form vs the saved {ref}: " + ", ".join(
                f"{n} {v:.3e}" for n, v in e.items()), flush=True)
        return
    args = _k2_inputs(K, True, B, D, A, hidden=(H, H))
    flat, layout, obs = args[:3]
    gen = torch.Generator(device="cuda").manual_seed(K)
    clear = fpg.redraw_near_kinks(flat, layout, obs, lambda n: torch.randn(
        n, D, device="cuda", generator=gen))
    even = torch.arange(B, device="cuda") % 2 == 0
    logp = fpg.policy_logp(flat, layout, clear, args[3], bf16=True)
    args_clear = (flat, layout, clear, args[3],
                  torch.where(even, logp, args[4]).contiguous()) + args[5:]
    for rows, a in (("natural", args), ("clear", args_clear)):
        gk, gp, g64 = (fpg.ppo_grad_rows(*a, **kw)[0],
                       fpg.ppo_grad_plain(*a, **kw)[0], _plain64_bf16(a, **kw)[0])
        e, ek, ep = (_tensor_errs(layout, gk, gp),
                     _tensor_errs(layout, gk, g64),
                     _tensor_errs(layout, gp, g64))
        for n in e:
            print(f"[reading bf16 {rows}] {n}: kernel vs plain {e[n]:.3e}; "
                  f"vs float64 kernel {ek[n]:.3e}, plain {ep[n]:.3e}",
                  flush=True)
        if rows == "natural":
            torch.save(dict(args=args, kernel=gk.cpu(), plain=gp.cpu(),
                            float64=g64.cpu()), path)
    # h1 and g_h2 from the scratch of one launch (its layout: carve() in
    # csrc/fused_ppo_grad_any.cu)
    lib = kernels.library()
    dims = (B, D, H, H, A, K)
    n = lib.fsrl_ppo_grad_any_scratch_floats(*dims)
    scratch = torch.zeros(n, device="cuda")
    grad, aux = torch.empty(layout.size, device="cuda"), torch.empty(
        8, device="cuda")
    ts = args[:1] + args[2:] + (grad, aux)
    kernels.check(lib.fsrl_ppo_grad_any(
        *(x.data_ptr() for x in ts), scratch.data_ptr(), *dims, 1, n, 0.8,
        1.2, 0.25, kernels.stream_ptr()), "generic K2")
    torch.cuda.synchronize()
    T = K + 1
    G = max(lib.fsrl_ppo_grad_any_row_blocks(*dims, b) for b in (0, 1))
    S = max(lib.fsrl_ppo_grad_any_splits(*dims, b) for b in (0, 1))
    sizes = [8 * G * T * (2 * H + A * H + 2 * A + 8),
             4 * S * T * (H * D + H * H), 4 * T * B * (2 * A + 2 + K)]
    sizes += [4 * T * B * H] * 4
    offs = [sum((x + 255) // 256 * 256 for x in sizes[:i])
            for i in range(len(sizes) + 1)]
    if offs[-1] // 4 != n:
        fail("the generic form's scratch layout changed")
    part = lambda i: scratch.view(torch.uint8)[offs[i]: offs[i] + 2 * T * B
                                               * H].view(torch.bfloat16) \
        .view(T, B, H).double()
    h1k, g2k = part(4), part(5)
    p = layout.views(flat)
    rb = lambda x: x.to(torch.bfloat16).to(x.dtype)
    towers = [tuple(p[f"actor.trunk.layers.{i}.{w}"] for i in (0, 1)
                    for w in ("weight", "bias"))]
    towers += [(p["critics.w.0"][k], p["critics.b.0"][k], p["critics.w.1"][k],
                p["critics.b.1"][k]) for k in range(K)]
    for t, (W1, b1, W2, b2) in enumerate(towers):
        h1p = rb(torch.relu(rb(obs) @ rb(W1).T + b1)).double()
        W1, b1, W2, b2 = (v.double() for v in (W1, b1, W2, b2))
        h1e = rb(torch.relu(rb(obs.double()) @ rb(W1).T + b1))
        z2e = h1e @ rb(W2).T + b2
        flip = (g2k[t] != 0) != (z2e > 0)
        own = (g2k[t] != 0) != (h1k[t] @ rb(W2).T + b2 > 0)
        differs = (h1k[t] != h1e).any(1)
        print(f"[reading bf16 h1] tower {t}: entries of h1 (of {B * H}) "
              f"whose bf16 value differs, kernel / plain "
              f"{int((h1k[t] != h1p).sum())}, kernel / float64 "
              f"{int((h1k[t] != h1e).sum())}, plain / float64 "
              f"{int((h1p != h1e).sum())}; ReLU sides of h2 unlike "
              f"float64's {int(flip.sum())} (|z2| at most "
              f"{float(z2e[flip].abs().max()) if flip.any() else 0.0:.2e}; "
              f"in rows whose h1 differs {int((flip & differs[:, None]).sum())}"
              f"), unlike a float64 product of the kernel's own h1 "
              f"{int(own.sum())}", flush=True)


def reading_host(label: str):
    """One host a40 PPO-Lag update (78 minibatches of 256 rows, repeat 4:
    312 launches of the generic form) on one collected segment, bf16 then
    f32: six updates on the host clock (the first a warm-up), then one
    under ``torch.profiler``: device time, kernel launches, the row
    kernel's device time a launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from fsrl_torch.algos.ppo_lag import PPOLag
    from fsrl_torch.trainer.host_trainer import HostOnpolicyTrainer
    n_mb = HOST_ENVS * HOST_T // 256
    for dtype in (torch.bfloat16, None):
        tag = f"reading host {label} {'bf16' if dtype else 'f32'}"
        venv = _standin_venv(HOST_ENVS, HOST_A40)
        algo = PPOLag(venv.observation_size, venv.action_size,
                      cost_limit=25.0, lagrangian_pid=(0.05, 0.0005, 0.1),
                      repeat=4, n_minibatches=n_mb, episode_len=HOST_EP,
                      compute_dtype=dtype)
        tr = HostOnpolicyTrainer(algo, venv, epochs=1,
                                 step_per_epoch=HOST_ENVS * HOST_T,
                                 steps_per_collect=HOST_T,
                                 episode_per_test=HOST_ENVS, cost_limit=25.0,
                                 seed=0, verbose=False)
        seg = tr.collect_segment()

        def update():
            tr.state, _ = tr.algo.update(tr.state, *seg, tr.generator)
        times = [_timed(update)[1] for _ in range(6)]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            update()
            torch.cuda.synchronize()
        ev = prof.key_averages()
        dev = lambda e: (getattr(e, "self_device_time_total", None)
                         or getattr(e, "self_cuda_time_total", 0))
        rows = [e for e in ev if "row_kernel" in e.key]
        print(f"[{tag}] update ms {[round(x, 2) for x in times]}, median of "
              f"the last 5 {statistics.median(times[1:]):.2f}; profiled: "
              f"device time {sum(dev(e) for e in ev) / 1e3:.2f} ms, "
              f"cudaLaunchKernel {sum(e.count for e in ev if e.key == 'cudaLaunchKernel')}"
              + (f", row kernel {dev(rows[0]) / rows[0].count:.1f} us a "
                 f"launch" if rows else ""), flush=True)
        venv.close()


if __name__ == "__main__":
    os.chdir(ROOT)
    if sys.argv[1:2] == ["--dp-rank"]:
        r, w, port, lib, out = sys.argv[2:7]
        sys.exit(dp_rank_main(int(r), int(w), port, lib, out))
    if sys.argv[1:2] == ["--k2-any-readings"]:
        import torch
        if not torch.cuda.is_available():
            fail("no CUDA device")
        torch.backends.cuda.matmul.allow_tf32 = False
        mode, arg = sys.argv[2:4]
        {"times": reading_times, "host": reading_host}.get(
            mode, lambda a: reading_bf16(a, "--against" in sys.argv))(arg)
        sys.exit(0)
    sys.exit(main())
