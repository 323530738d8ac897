// One on-policy collector segment (T steps x N envs) as one kernel: the
// Gaussian actor's forward and sample, the action map, the car or ball
// physics, the task's observation, reward and cost, the step clock, the
// auto-reset and the episode accumulators, every step's transition written
// straight into the time-major (T, N, ...) segment. The actor has two ReLU
// layers of 128 units (rollout_kernel) or of 256 (rollout_kernel_h256).
//
// Replaces no Pallas kernel: JAX's rollout (fsrl_tpu/data/collector.py) is
// one lax.scan that XLA fuses. In PyTorch the same loop
// (fsrl_torch/data/collector.py) is about 160 small kernels an env step: a
// CUDA graph of 64 steps of 4096 envs holds 10,270 nodes.
//
// Bound on this card: the actor's f32 products. An env step costs
// 2 x (D*H + H*H + H*A) FLOP (D 9, A 2): ~35.6 kFLOP at H 128, so a
// segment of 4096 x 64 is 9.3 GFLOP, ~0.14 ms at 67 TFLOP/s of non-tensor
// f32 FMA; ~136.7 kFLOP at H 256, 35.8 GFLOP, ~0.535 ms. The transitions
// written are ~92 bytes an env step, 24 MB a segment, ~7 us at 3.35 TB/s;
// the env arithmetic is a few hundred operations an env step. So the
// kernel is latency-bound on its T sequential steps.
//
// Design at H 128 (rollout_kernel):
// * A block owns E envs for all T steps, 128 threads (4 warps); the first E
//   lanes of warp 0 step the envs, each env's state and accumulators in its
//   lane's registers. E is 32, or 16 where 32 would leave fewer than two
//   blocks an SM (the wrapper's choice): 4096 envs make 256 blocks of 16,
//   16384 make 512 of 32, two blocks to an SM, so one block's env step runs
//   beside the other's products.
// * W2 (transposed, 66 KB) stays in shared memory; W1's row of each thread,
//   b2, the head and log-sigma in registers. Per step: the step's draws are
//   read first, their latency hidden by the products; layer 1 (thread j
//   computes unit j for the E envs), layer 2 (warp w computes E/4 envs x 128
//   units, 4 units a lane, from float4 reads of W2^T and h1^T), the head as
//   a lane's partial over its 4 units summed by a butterfly, then warp 0
//   steps its envs. Three block barriers a step.
// Design at H 256 (rollout_kernel_h256): W2^T would take 266 KB, more than
// the 227 KB a block may have, so
// * a cluster of two blocks, on two SMs, owns 64 envs for all T steps, 256
//   threads a block. Block r keeps in shared memory the half of W2 whose 128
//   outputs it computes (transposed, 132 KB), and computes all 256 units of
//   layer 1 itself (a tenth of layer 2's products, and no exchange of h1).
// * Layer 2: warp w computes 8 envs x the block's 128 units, 4 units a
//   lane, as at H 128; the head's partial sum over the block's units (a
//   butterfly) is stored into its own and the other block's shared memory
//   (distributed shared memory), in buffers of alternate steps, and one
//   cluster barrier makes both halves visible. Each block adds the halves
//   in rank order, so both hold the same means; both step the 64 envs
//   (threads 0-63) on the same draws with the same arithmetic, and block 0
//   alone writes the segment, the final state and the sums. Two block
//   barriers and one cluster barrier a step.
// At both widths:
// * Products are f32 FMAs (fmaf), never TF32; no fast math.
// * The env, task, reset and accumulator arithmetic is spelled with
//   __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn in PyTorch's operation
//   order (a division by a Python float is ATen's product with its float
//   reciprocal), so nothing is contracted: given the same actions the
//   kernel's steps are the loop's, bit for bit.
// * Randomness is the caller's: the actions' normal draws (T, N, A) and
//   the reset draws, made by PyTorch in the loop's order.
// * The episode aggregates are summed in a fixed order, with no float
//   atomics: each lane sums the episodes its env finishes, warp butterflies
//   sum the block's (at H 256 warp 0's plus warp 1's) into its scratch row,
//   and the last block to finish (an integer counter) sums the rows in a
//   fixed order. A replay equals its eager call bit for bit; counts and
//   costs are integers in f32 and come out exact.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

// Every constant as the float PyTorch rounds it to (fsrl_torch/ops/
// rollout_kernel.py computes them from the env modules).
struct RolloutConsts {
  float act_low, act_high, act_range;      // the action map and clamp
  float dt, accel, drag, dt_steer;         // physics
  float inv_vel_scale, inv_pos_scale;      // observation scales
  float y_lim, inv_y_lim, speed_limit, inv_speed_limit, inv_v_target;
  float radius, inv_radius, x_lim;
  float theta_low, theta_range, half_pi;   // circle spawns
  float r_low, r_range;                    // the ball's circle radius draw
  float pos_low, pos_range;                // run spawns
  float s_low, s_range;                    // car heading / ball velocity
  float max_action, sigma_floor, log_sqrt_2pi;
};

struct RolloutArgs {
  // actor, PyTorch's (out, in) layout
  const float *w1, *b1, *w2, *b2, *wmu, *bmu, *log_sigma;
  // draws: the actions' noise (T, N, A); the reset draws (T, N, c0) and
  // (T, N, c1)
  const float *noise, *u0, *u1;
  // given actions (T, N, A) and log-probs (T, N) in place of the actor
  const float *act_in, *logp_in;
  // env state: pos (N, 2); car heading, speed (N); ball vel (N, 2)
  const float *pos, *sa, *sb, *obs;
  const int* t;
  float *pos_o, *sa_o, *sb_o, *obs_o;
  int* t_o;
  // episode statistics
  const float *ep_r, *ep_c;
  const int* ep_l;
  float *ep_r_o, *ep_c_o;
  int* ep_l_o;
  const int *n_episodes, *n_steps, *n_term, *n_trunc;
  const float *sum_r, *sum_c, *sum_l;
  int *n_episodes_o, *n_steps_o, *n_term_o, *n_trunc_o;
  float *sum_r_o, *sum_c_o, *sum_l_o;
  // the segment
  float *tr_obs, *tr_act, *tr_obs_next, *tr_reward, *tr_cost, *tr_logp;
  uint8_t *tr_term, *tr_trunc;
  // scratch: per step and block, (reward, len, cost...) and (done, term,
  // trunc); the blocks' counter, zero at launch
  float* part_f;
  int* part_i;
  int* counter;
  int T, N, D, M, max_steps, floored;
};

namespace {

using Consts = RolloutConsts;
using Args = RolloutArgs;
namespace cg = cooperative_groups;

constexpr int A = 2;         // actions (car and ball)
constexpr int DMAX = 16;     // observation width
constexpr int MMAX = 2;      // cost channels

// H 128: a block of NT threads owns E envs
constexpr int NT = 128;      // threads a block
constexpr int NW = NT / 32;  // warps
constexpr int H = 128;       // hidden width of both layers
constexpr int W2S = H + 4;   // row stride of W2^T in shared memory
constexpr int UL = H / 32;   // units a lane in layer 2

// H 256: a cluster of RANKS blocks of NTW threads owns EC envs
constexpr int HW = 256;          // hidden width of both layers
constexpr int RANKS = 2;         // blocks a cluster
constexpr int HU = HW / RANKS;   // layer-2 units a block
constexpr int NTW = 256;         // threads a block, one a layer-1 unit
constexpr int NWW = NTW / 32;    // warps
constexpr int EC = 64;           // envs a cluster
constexpr int W2SW = HU + 4;     // row stride of the block's half of W2^T
constexpr int H1SW = EC + 4;     // row stride of h1^T
constexpr int EWW = EC / NWW;    // envs a warp in layer 2
static_assert(HU / 32 == UL && NTW == HW && EC % 32 == 0, "H 256 layout");

enum Env { CAR = 0, BALL = 1 };
enum Task { RUN = 0, CIRCLE = 1, CIRCLE2 = 2 };

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float norm2(float x, float y) {
  return __fsqrt_rn(add(mul(x, x), mul(y, y)));
}

// One env's sim state: car (pos, heading, speed), ball (pos, vel).
struct Sim {
  float px, py, a, b;
};

// The task's reward, costs and observation extras (envs/tasks.py).
template <int TASK>
__device__ __forceinline__ void task_eval(const Consts& k, float px, float py,
                                          float vx, float vy, float* ex,
                                          float& reward, float* cost) {
  if (TASK == RUN) {
    reward = mul(vx, k.inv_v_target);
    const float speed = norm2(vx, vy);
    cost[0] = (fabsf(py) > k.y_lim || speed > k.speed_limit) ? 1.0f : 0.0f;
    ex[0] = mul(py, k.inv_y_lim);
    ex[1] = mul(sub(k.y_lim, fabsf(py)), k.inv_y_lim);
    ex[2] = mul(sub(k.speed_limit, speed), k.inv_speed_limit);
  } else {
    const float dist = norm2(px, py);
    reward = __fdiv_rn(add(mul(-py, vx), mul(px, vy)),
                       mul(add(fabsf(sub(dist, k.radius)), 1.0f), k.radius));
    cost[0] = fabsf(px) > k.x_lim ? 1.0f : 0.0f;
    ex[0] = mul(px, k.inv_radius);
    ex[1] = mul(py, k.inv_radius);
    ex[2] = mul(sub(dist, k.radius), k.inv_radius);
    ex[3] = mul(sub(k.x_lim, fabsf(px)), k.inv_radius);
    if (TASK == CIRCLE2) {
      const float speed = norm2(vx, vy);
      cost[1] = speed > k.speed_limit ? 1.0f : 0.0f;
      ex[4] = mul(sub(k.speed_limit, speed), k.inv_speed_limit);
    }
  }
}

// The observation of a sim state; with reward and costs when asked.
template <int ENV, int TASK>
__device__ __forceinline__ void observe(const Consts& k, const Sim& s,
                                        float* o, float& reward, float* cost) {
  float vx, vy;
  if (ENV == CAR) {
    const float c = cosf(s.a), sn = sinf(s.a);
    vx = mul(s.b, c);
    vy = mul(s.b, sn);
    o[0] = mul(vx, k.inv_vel_scale);
    o[1] = mul(vy, k.inv_vel_scale);
    o[2] = c;
    o[3] = sn;
    o[4] = mul(s.b, k.inv_vel_scale);
    task_eval<TASK>(k, s.px, s.py, vx, vy, o + 5, reward, cost);
  } else {
    vx = s.a;
    vy = s.b;
    o[0] = mul(vx, k.inv_vel_scale);
    o[1] = mul(vy, k.inv_vel_scale);
    o[2] = tanhf(mul(s.px, k.inv_pos_scale));
    o[3] = tanhf(mul(s.py, k.inv_pos_scale));
    task_eval<TASK>(k, s.px, s.py, vx, vy, o + 4, reward, cost);
  }
}

// One physics step under the clamped env action (car.py, ball.py).
template <int ENV>
__device__ __forceinline__ Sim physics(const Consts& k, const Sim& s,
                                       float a0, float a1) {
  Sim n;
  if (ENV == CAR) {
    n.b = add(s.b, mul(k.dt, sub(mul(k.accel, a0), mul(k.drag, s.b))));
    n.a = add(s.a, mul(k.dt_steer, a1));
    const float c = cosf(n.a), sn = sinf(n.a);
    n.px = add(s.px, mul(k.dt, mul(n.b, c)));
    n.py = add(s.py, mul(k.dt, mul(n.b, sn)));
  } else {
    n.a = add(s.a, mul(k.dt, sub(mul(k.accel, a0), mul(k.drag, s.a))));
    n.b = add(s.b, mul(k.dt, sub(mul(k.accel, a1), mul(k.drag, s.b))));
    n.px = add(s.px, mul(k.dt, n.a));
    n.py = add(s.py, mul(k.dt, n.b));
  }
  return n;
}

// The reset state from one env's reset draws (_init_sim_from).
template <int ENV, int TASK>
__device__ __forceinline__ Sim spawn(const Consts& k, const float* u0,
                                     const float* u1) {
  Sim s;
  if (TASK != RUN) {
    const float theta = add(mul(k.theta_range, u0[0]), k.theta_low);
    const float c = cosf(theta), sn = sinf(theta);
    if (ENV == CAR) {
      s.px = mul(c, k.radius);
      s.py = mul(sn, k.radius);
      s.a = add(theta, k.half_pi);
      s.b = 0.0f;
    } else {
      const float r = add(add(mul(k.r_range, u1[0]), k.r_low), k.radius);
      s.px = mul(r, c);
      s.py = mul(r, sn);
      s.a = 0.0f;
      s.b = 0.0f;
    }
    s.px = clampf(s.px, -k.x_lim, k.x_lim);
  } else {
    s.px = add(mul(k.pos_range, u0[0]), k.pos_low);
    s.py = add(mul(k.pos_range, u0[1]), k.pos_low);
    if (ENV == CAR) {
      s.a = add(mul(k.s_range, u1[0]), k.s_low);
      s.b = 0.0f;
    } else {
      s.a = add(mul(k.s_range, u1[0]), k.s_low);
      s.b = add(mul(k.s_range, u1[1]), k.s_low);
    }
  }
  return s;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = add(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// H 128: E envs a block (the first E lanes of warp 0 step them), E / NW a
// warp in layer 2.
template <int E>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)H * W2S + (size_t)H * (E + 4) + E * DMAX + E * A);
}

template <int ENV, int TASK, int E>
__global__ void __launch_bounds__(NT)
rollout_kernel(const Args a, const Consts k) {
  constexpr int H1S = E + 4;   // row stride of h1^T
  constexpr int EW = E / NW;   // envs a warp in layer 2
  constexpr int C0 = TASK == RUN ? 2 : 1;   // columns of the reset draws
  constexpr int C1 = ENV == CAR ? 1 : (TASK == RUN ? 2 : 1);
  extern __shared__ __align__(16) float smem[];
  float* w2t = smem;                  // [H][W2S]: W2^T
  float* h1t = w2t + H * W2S;         // [H][H1S]: h1^T
  float* obs_s = h1t + H * H1S;       // [E][DMAX]: the current observations
  float* mu_s = obs_s + E * DMAX;     // [E][A]: the head's outputs
  __shared__ int s_last;

  const int T = a.T, N = a.N, D = a.D, M = a.M;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nb = gridDim.x, blk = blockIdx.x;
  const int n = blk * E + lane;             // warp 0's env
  const bool live = warp == 0 && lane < E && n < N;
  const bool actor = a.act_in == nullptr;

  // weights
  float w1r[DMAX], b1r = 0.0f, b2r[UL], wmur[A][UL], bmur[A];
  if (actor) {
    for (int i = tid; i < H * H; i += NT) {
      const int j = i / H, kk = i % H;      // W2[j][kk], read in rows
      w2t[kk * W2S + j] = a.w2[i];
    }
#pragma unroll
    for (int kk = 0; kk < DMAX; ++kk) w1r[kk] = kk < D ? a.w1[tid * D + kk] : 0.0f;
    b1r = a.b1[tid];
#pragma unroll
    for (int i = 0; i < UL; ++i) {
      b2r[i] = a.b2[4 * lane + i];
#pragma unroll
      for (int q = 0; q < A; ++q) wmur[q][i] = a.wmu[q * H + 4 * lane + i];
    }
#pragma unroll
    for (int q = 0; q < A; ++q) bmur[q] = a.bmu[q];
  }
  float sd[A], log_sd[A];
#pragma unroll
  for (int q = 0; q < A; ++q) {
    const float ls = !actor ? 0.0f
                     : a.floored ? fmaxf(a.log_sigma[q], logf(k.sigma_floor))
                                 : a.log_sigma[q];
    sd[q] = expf(ls);
    log_sd[q] = logf(sd[q]);
  }

  // warp 0: its envs' state and accumulators, and the sums of the
  // episodes they finish (return, length, costs; count)
  Sim s{};
  int tc = 0, ep_l = 0, done_n = 0;
  float ep_r = 0.0f, ep_c[MMAX] = {0.0f, 0.0f};
  float fin_r = 0.0f, fin_l = 0.0f, fin_c[MMAX] = {0.0f, 0.0f};
  if (warp == 0 && lane < E) {
    for (int kk = 0; kk < DMAX; ++kk)
      obs_s[lane * DMAX + kk] = live && kk < D ? a.obs[(size_t)n * D + kk] : 0.0f;
    if (live) {
      s.px = a.pos[2 * n];
      s.py = a.pos[2 * n + 1];
      if (ENV == CAR) {
        s.a = a.sa[n];
        s.b = a.sb[n];
      } else {
        s.a = a.sa[2 * n];
        s.b = a.sa[2 * n + 1];
      }
      tc = a.t[n];
      ep_r = a.ep_r[n];
      for (int m = 0; m < M; ++m) ep_c[m] = a.ep_c[n * M + m];
      ep_l = a.ep_l[n];
    }
  }

  for (int t = 0; t < T; ++t) {
    const size_t tn = (size_t)t * N + n;
    // the step's draws, read before the products hide their latency
    float act[A], logp = 0.0f, u0[C0], u1[C1];
    if (live) {
#pragma unroll
      for (int q = 0; q < A; ++q)
        act[q] = actor ? a.noise[tn * A + q] : a.act_in[tn * A + q];
      if (!actor) logp = a.logp_in[tn];
#pragma unroll
      for (int i = 0; i < C0; ++i) u0[i] = a.u0[tn * C0 + i];
#pragma unroll
      for (int i = 0; i < C1; ++i) u1[i] = a.u1 == nullptr ? 0.0f : a.u1[tn * C1 + i];
    }
    __syncthreads();   // obs_s holds step t's observations
    if (actor) {
      // layer 1: unit tid for every env, h1^T[tid][e]
#pragma unroll 4
      for (int e = 0; e < E; ++e) {
        float acc = 0.0f;
#pragma unroll
        for (int kk = 0; kk < DMAX; ++kk)
          if (kk < D) acc = fmaf(obs_s[e * DMAX + kk], w1r[kk], acc);
        h1t[tid * H1S + e] = fmaxf(add(acc, b1r), 0.0f);
      }
      __syncthreads();
      // layer 2: envs EW*warp.., units 4*lane..; then the head
      float acc[EW][UL];
#pragma unroll
      for (int e = 0; e < EW; ++e)
#pragma unroll
        for (int i = 0; i < UL; ++i) acc[e][i] = 0.0f;
#pragma unroll 4
      for (int kk = 0; kk < H; ++kk) {
        const float4 w = *reinterpret_cast<const float4*>(w2t + kk * W2S + 4 * lane);
        const float wv[UL] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int e4 = 0; e4 < EW; e4 += 4) {
          const float4 h = *reinterpret_cast<const float4*>(h1t + kk * H1S + EW * warp + e4);
          const float hv[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int i = 0; i < UL; ++i)
              acc[e4 + e][i] = fmaf(hv[e], wv[i], acc[e4 + e][i]);
        }
      }
#pragma unroll
      for (int e = 0; e < EW; ++e) {
#pragma unroll
        for (int q = 0; q < A; ++q) {
          float p = 0.0f;
#pragma unroll
          for (int i = 0; i < UL; ++i)
            p = fmaf(fmaxf(add(acc[e][i], b2r[i]), 0.0f), wmur[q][i], p);
          p = warp_sum(p);
          if (lane == 0) mu_s[(EW * warp + e) * A + q] = add(p, bmur[q]);
        }
      }
      __syncthreads();
    }

    if (live) {
      if (actor) {
        // the sample and its log-prob; act holds the noise
#pragma unroll
        for (int q = 0; q < A; ++q) {
          const float mean = mul(k.max_action, tanhf(mu_s[lane * A + q]));
          act[q] = add(mean, mul(sd[q], act[q]));
          const float z = __fdiv_rn(sub(act[q], mean), sd[q]);
          const float pd = sub(sub(mul(mul(z, -0.5f), z), log_sd[q]),
                               k.log_sqrt_2pi);
          logp = q == 0 ? pd : add(logp, pd);
        }
      }
      for (int kk = 0; kk < D; ++kk)
        a.tr_obs[tn * D + kk] = obs_s[lane * DMAX + kk];
#pragma unroll
      for (int q = 0; q < A; ++q) a.tr_act[tn * A + q] = act[q];
      a.tr_logp[tn] = logp;

      // map_action, then the env's clamp
      float ea[A];
#pragma unroll
      for (int q = 0; q < A; ++q) {
        const float c = clampf(act[q], -1.0f, 1.0f);
        const float m = add(mul(mul(k.act_range, add(c, 1.0f)), 0.5f), k.act_low);
        ea[q] = clampf(m, k.act_low, k.act_high);
      }
      s = physics<ENV>(k, s, ea[0], ea[1]);
      float o[DMAX], reward, cost[MMAX] = {0.0f, 0.0f};
      observe<ENV, TASK>(k, s, o, reward, cost);
      tc += 1;
      const bool trunc = tc >= a.max_steps;   // car and ball never terminate
      for (int kk = 0; kk < D; ++kk) a.tr_obs_next[tn * D + kk] = o[kk];
      a.tr_reward[tn] = reward;
      for (int m = 0; m < M; ++m) a.tr_cost[tn * M + m] = cost[m];
      a.tr_term[tn] = 0;
      a.tr_trunc[tn] = trunc;

      // EpisodeStats.update
      ep_r = add(ep_r, reward);
      for (int m = 0; m < M; ++m) ep_c[m] = add(ep_c[m], cost[m]);
      ep_l += 1;
      if (trunc) {
        fin_r = add(fin_r, ep_r);
        for (int m = 0; m < M; ++m) fin_c[m] = add(fin_c[m], ep_c[m]);
        fin_l = add(fin_l, (float)ep_l);
        done_n += 1;
        ep_r = 0.0f;
        for (int m = 0; m < M; ++m) ep_c[m] = 0.0f;
        ep_l = 0;
        // step_autoreset: the fresh state where done
        s = spawn<ENV, TASK>(k, u0, u1);
        float r2, c2[MMAX];
        observe<ENV, TASK>(k, s, o, r2, c2);
        tc = 0;
      }
      for (int kk = 0; kk < D; ++kk) obs_s[lane * DMAX + kk] = o[kk];
    }
  }

  if (warp == 0) {
    // the final env state and accumulators
    if (live) {
      a.pos_o[2 * n] = s.px;
      a.pos_o[2 * n + 1] = s.py;
      if (ENV == CAR) {
        a.sa_o[n] = s.a;
        a.sb_o[n] = s.b;
      } else {
        a.sa_o[2 * n] = s.a;
        a.sa_o[2 * n + 1] = s.b;
      }
      for (int kk = 0; kk < D; ++kk) a.obs_o[(size_t)n * D + kk] = obs_s[lane * DMAX + kk];
      a.t_o[n] = tc;
      a.ep_r_o[n] = ep_r;
      for (int m = 0; m < M; ++m) a.ep_c_o[n * M + m] = ep_c[m];
      a.ep_l_o[n] = ep_l;
    }
    // the block's sums of the finished episodes, in a fixed order
    fin_r = warp_sum(fin_r);
    fin_l = warp_sum(fin_l);
    for (int m = 0; m < M; ++m) fin_c[m] = warp_sum(fin_c[m]);
    done_n = __reduce_add_sync(0xffffffffu, done_n);
    if (lane == 0) {
      float* pf = a.part_f + (size_t)blk * (2 + M);
      pf[0] = fin_r;
      pf[1] = fin_l;
      for (int m = 0; m < M; ++m) pf[2 + m] = fin_c[m];
      a.part_i[blk] = done_n;
      __threadfence();
      s_last = atomicAdd(a.counter, 1) == nb - 1;
    }
  }
  __syncthreads();
  if (!s_last || warp != 0) return;
  // the last block to finish: the blocks' sums, in a fixed order
  __threadfence();
  float f[2 + MMAX] = {0.0f, 0.0f, 0.0f, 0.0f};
  int c = 0;
  for (int b = lane; b < nb; b += 32) {
    const float* pf = a.part_f + (size_t)b * (2 + M);
    for (int i = 0; i < 2 + M; ++i) f[i] = add(f[i], __ldcg(pf + i));
    c += __ldcg(a.part_i + b);
  }
  for (int i = 0; i < 2 + M; ++i) f[i] = warp_sum(f[i]);
  c = __reduce_add_sync(0xffffffffu, c);
  if (lane == 0) {
    a.sum_r_o[0] = add(a.sum_r[0], f[0]);
    a.sum_l_o[0] = add(a.sum_l[0], f[1]);
    for (int m = 0; m < M; ++m) a.sum_c_o[m] = add(a.sum_c[m], f[2 + m]);
    a.n_episodes_o[0] = a.n_episodes[0] + c;
    a.n_term_o[0] = a.n_term[0];
    a.n_trunc_o[0] = a.n_trunc[0] + c;
    a.n_steps_o[0] = a.n_steps[0] + T * N;
  }
}

// H 256: the 128-unit kernel's per-env code, as functions of one env's
// lane. The 128-unit kernel keeps its own text: built from these functions
// it compiled to other code (80 registers in place of 95, a larger stack)
// and its launch took 12% longer at 4096 x 64 on an H100.

// One env's state and accumulators, and the sums of the episodes it
// finishes (return, length, costs; count), in its lane's registers.
struct Lane {
  Sim s;
  int tc, ep_l, done_n;
  float ep_r, fin_r, fin_l;
  float ep_c[MMAX], fin_c[MMAX];
};

// A lane's env at the segment's start: its observation into obs_row (zeros
// past D, and where not live), its state and accumulators where live.
template <int ENV>
__device__ __forceinline__ void lane_load(const Args& a, int n, bool live,
                                          float* obs_row, Lane& L) {
  const int D = a.D, M = a.M;
  for (int kk = 0; kk < DMAX; ++kk)
    obs_row[kk] = live && kk < D ? a.obs[(size_t)n * D + kk] : 0.0f;
  if (live) {
    L.s.px = a.pos[2 * n];
    L.s.py = a.pos[2 * n + 1];
    if (ENV == CAR) {
      L.s.a = a.sa[n];
      L.s.b = a.sb[n];
    } else {
      L.s.a = a.sa[2 * n];
      L.s.b = a.sa[2 * n + 1];
    }
    L.tc = a.t[n];
    L.ep_r = a.ep_r[n];
    for (int m = 0; m < M; ++m) L.ep_c[m] = a.ep_c[n * M + m];
    L.ep_l = a.ep_l[n];
  }
}

// A live lane's draws of step tn: the actions' noise (or the given actions
// and log-prob) and the reset draws.
template <int C0, int C1>
__device__ __forceinline__ void read_draws(const Args& a, size_t tn, bool actor,
                                           float* act, float& logp, float* u0,
                                           float* u1) {
#pragma unroll
  for (int q = 0; q < A; ++q)
    act[q] = actor ? a.noise[tn * A + q] : a.act_in[tn * A + q];
  if (!actor) logp = a.logp_in[tn];
#pragma unroll
  for (int i = 0; i < C0; ++i) u0[i] = a.u0[tn * C0 + i];
#pragma unroll
  for (int i = 0; i < C1; ++i) u1[i] = a.u1 == nullptr ? 0.0f : a.u1[tn * C1 + i];
}

// A live lane's env step tn: with the actor, the sample and its log-prob
// from the head's outputs mu (act holds the noise); the transition written
// where write; the action map, the physics, the task, the clock,
// EpisodeStats.update and the auto-reset; the next observation into
// obs_row.
template <int ENV, int TASK>
__device__ __forceinline__ void env_step(const Args& a, const Consts& k,
                                         size_t tn, bool actor, bool write,
                                         const float* mu, const float* sd,
                                         const float* log_sd, float* act,
                                         float logp, const float* u0,
                                         const float* u1, float* obs_row,
                                         Lane& L) {
  const int D = a.D, M = a.M;
  if (actor) {
#pragma unroll
    for (int q = 0; q < A; ++q) {
      const float mean = mul(k.max_action, tanhf(mu[q]));
      act[q] = add(mean, mul(sd[q], act[q]));
      const float z = __fdiv_rn(sub(act[q], mean), sd[q]);
      const float pd = sub(sub(mul(mul(z, -0.5f), z), log_sd[q]),
                           k.log_sqrt_2pi);
      logp = q == 0 ? pd : add(logp, pd);
    }
  }
  if (write) {
    for (int kk = 0; kk < D; ++kk) a.tr_obs[tn * D + kk] = obs_row[kk];
#pragma unroll
    for (int q = 0; q < A; ++q) a.tr_act[tn * A + q] = act[q];
    a.tr_logp[tn] = logp;
  }

  // map_action, then the env's clamp
  float ea[A];
#pragma unroll
  for (int q = 0; q < A; ++q) {
    const float c = clampf(act[q], -1.0f, 1.0f);
    const float m = add(mul(mul(k.act_range, add(c, 1.0f)), 0.5f), k.act_low);
    ea[q] = clampf(m, k.act_low, k.act_high);
  }
  L.s = physics<ENV>(k, L.s, ea[0], ea[1]);
  float o[DMAX], reward, cost[MMAX] = {0.0f, 0.0f};
  observe<ENV, TASK>(k, L.s, o, reward, cost);
  L.tc += 1;
  const bool trunc = L.tc >= a.max_steps;   // car and ball never terminate
  if (write) {
    for (int kk = 0; kk < D; ++kk) a.tr_obs_next[tn * D + kk] = o[kk];
    a.tr_reward[tn] = reward;
    for (int m = 0; m < M; ++m) a.tr_cost[tn * M + m] = cost[m];
    a.tr_term[tn] = 0;
    a.tr_trunc[tn] = trunc;
  }

  // EpisodeStats.update
  L.ep_r = add(L.ep_r, reward);
  for (int m = 0; m < M; ++m) L.ep_c[m] = add(L.ep_c[m], cost[m]);
  L.ep_l += 1;
  if (trunc) {
    L.fin_r = add(L.fin_r, L.ep_r);
    for (int m = 0; m < M; ++m) L.fin_c[m] = add(L.fin_c[m], L.ep_c[m]);
    L.fin_l = add(L.fin_l, (float)L.ep_l);
    L.done_n += 1;
    L.ep_r = 0.0f;
    for (int m = 0; m < M; ++m) L.ep_c[m] = 0.0f;
    L.ep_l = 0;
    // step_autoreset: the fresh state where done
    L.s = spawn<ENV, TASK>(k, u0, u1);
    float r2, c2[MMAX];
    observe<ENV, TASK>(k, L.s, o, r2, c2);
    L.tc = 0;
  }
  for (int kk = 0; kk < D; ++kk) obs_row[kk] = o[kk];
}

// A live lane's final env state and accumulators.
template <int ENV>
__device__ __forceinline__ void lane_store(const Args& a, int n,
                                           const float* obs_row, const Lane& L) {
  const int D = a.D, M = a.M;
  a.pos_o[2 * n] = L.s.px;
  a.pos_o[2 * n + 1] = L.s.py;
  if (ENV == CAR) {
    a.sa_o[n] = L.s.a;
    a.sb_o[n] = L.s.b;
  } else {
    a.sa_o[2 * n] = L.s.a;
    a.sa_o[2 * n + 1] = L.s.b;
  }
  for (int kk = 0; kk < D; ++kk) a.obs_o[(size_t)n * D + kk] = obs_row[kk];
  a.t_o[n] = L.tc;
  a.ep_r_o[n] = L.ep_r;
  for (int m = 0; m < M; ++m) a.ep_c_o[n * M + m] = L.ep_c[m];
  a.ep_l_o[n] = L.ep_l;
}

// A warp's sums of its lanes' finished episodes, in a fixed order.
__device__ __forceinline__ void warp_sums(int M, Lane& L) {
  L.fin_r = warp_sum(L.fin_r);
  L.fin_l = warp_sum(L.fin_l);
  for (int m = 0; m < M; ++m) L.fin_c[m] = warp_sum(L.fin_c[m]);
  L.done_n = __reduce_add_sync(0xffffffffu, L.done_n);
}

// Row `row` of the scratch: its finished episodes' sums; then the counter.
// True in the last of `rows` to finish.
__device__ __forceinline__ bool put_row(const Args& a, int row, int rows,
                                        const Lane& L) {
  float* pf = a.part_f + (size_t)row * (2 + a.M);
  pf[0] = L.fin_r;
  pf[1] = L.fin_l;
  for (int m = 0; m < a.M; ++m) pf[2 + m] = L.fin_c[m];
  a.part_i[row] = L.done_n;
  __threadfence();
  return atomicAdd(a.counter, 1) == rows - 1;
}

// The last to finish, one warp: the rows' sums, in a fixed order, added to
// the statistics.
__device__ __forceinline__ void sum_rows(const Args& a, int rows, int lane) {
  const int M = a.M;
  __threadfence();
  float f[2 + MMAX] = {0.0f, 0.0f, 0.0f, 0.0f};
  int c = 0;
  for (int b = lane; b < rows; b += 32) {
    const float* pf = a.part_f + (size_t)b * (2 + M);
    for (int i = 0; i < 2 + M; ++i) f[i] = add(f[i], __ldcg(pf + i));
    c += __ldcg(a.part_i + b);
  }
  for (int i = 0; i < 2 + M; ++i) f[i] = warp_sum(f[i]);
  c = __reduce_add_sync(0xffffffffu, c);
  if (lane == 0) {
    a.sum_r_o[0] = add(a.sum_r[0], f[0]);
    a.sum_l_o[0] = add(a.sum_l[0], f[1]);
    for (int m = 0; m < M; ++m) a.sum_c_o[m] = add(a.sum_c[m], f[2 + m]);
    a.n_episodes_o[0] = a.n_episodes[0] + c;
    a.n_term_o[0] = a.n_term[0];
    a.n_trunc_o[0] = a.n_trunc[0] + c;
    a.n_steps_o[0] = a.n_steps[0] + a.T * a.N;
  }
}

// The log-sigma of the actor, floored where asked, as std and its log.
__device__ __forceinline__ void log_sigma(const Args& a, const Consts& k,
                                          bool actor, float* sd, float* log_sd) {
#pragma unroll
  for (int q = 0; q < A; ++q) {
    const float ls = !actor ? 0.0f
                     : a.floored ? fmaxf(a.log_sigma[q], logf(k.sigma_floor))
                                 : a.log_sigma[q];
    sd[q] = expf(ls);
    log_sd[q] = logf(sd[q]);
  }
}

// H 256: the cluster's EC envs are stepped by threads 0..EC-1 of each block.
constexpr size_t smem_bytes_h256() {
  return sizeof(float) * ((size_t)HW * W2SW + (size_t)HW * H1SW + EC * DMAX
                          + 2 * RANKS * EC * A);
}

template <int ENV, int TASK>
__global__ void __cluster_dims__(RANKS, 1, 1) __launch_bounds__(NTW)
rollout_kernel_h256(const Args a, const Consts k) {
  constexpr int C0 = TASK == RUN ? 2 : 1;   // columns of the reset draws
  constexpr int C1 = ENV == CAR ? 1 : (TASK == RUN ? 2 : 1);
  constexpr int HEAD = RANKS * EC * A;     // a step's head sums
  extern __shared__ __align__(16) float smem[];
  float* w2t = smem;                  // [HW][W2SW]: this block's half of W2^T
  float* h1t = w2t + HW * W2SW;       // [HW][H1SW]: h1^T
  float* obs_s = h1t + HW * H1SW;     // [EC][DMAX]: the current observations
  float* head = obs_s + EC * DMAX;    // [2][RANKS][EC][A]: each block's head
                                      // sums over its units, alternate steps
  __shared__ float s_fin[2 + MMAX];
  __shared__ int s_done, s_last;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  float* head_peer = cluster.map_shared_rank(head, rank ^ 1);
  const int T = a.T, N = a.N, D = a.D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rows = gridDim.x / RANKS, row = blockIdx.x / RANKS;
  const int n = row * EC + tid;             // the env of threads 0..EC-1
  const bool stepper = tid < EC;
  const bool live = stepper && n < N;
  const bool actor = a.act_in == nullptr;
  const bool writer = rank == 0;            // writes the segment

  // weights: the block's half of W2, W1's row of unit tid
  float w1r[DMAX], b1r = 0.0f, b2r[UL], wmur[A][UL], bmur[A];
  if (actor) {
    for (int i = tid; i < HU * HW; i += NTW) {
      const int j = i / HW, kk = i % HW;    // W2[rank*HU + j][kk], in rows
      w2t[kk * W2SW + j] = a.w2[(size_t)rank * HU * HW + i];
    }
#pragma unroll
    for (int kk = 0; kk < DMAX; ++kk) w1r[kk] = kk < D ? a.w1[tid * D + kk] : 0.0f;
    b1r = a.b1[tid];
#pragma unroll
    for (int i = 0; i < UL; ++i) {
      b2r[i] = a.b2[rank * HU + 4 * lane + i];
#pragma unroll
      for (int q = 0; q < A; ++q) wmur[q][i] = a.wmu[q * HW + rank * HU + 4 * lane + i];
    }
#pragma unroll
    for (int q = 0; q < A; ++q) bmur[q] = a.bmu[q];
    // both blocks have started before either writes into the other
    cluster.sync();
  }
  float sd[A], log_sd[A];
  log_sigma(a, k, actor, sd, log_sd);

  Lane L{};
  if (stepper) lane_load<ENV>(a, n, live, obs_s + tid * DMAX, L);

  for (int t = 0; t < T; ++t) {
    const size_t tn = (size_t)t * N + n;
    float act[A], logp = 0.0f, u0[C0], u1[C1];
    if (live) read_draws<C0, C1>(a, tn, actor, act, logp, u0, u1);
    __syncthreads();   // obs_s holds step t's observations
    float* hd = head + (t & 1) * HEAD;
    if (actor) {
      // layer 1: unit tid for every env, h1^T[tid][e]
#pragma unroll 4
      for (int e = 0; e < EC; ++e) {
        float acc = 0.0f;
#pragma unroll
        for (int kk = 0; kk < DMAX; ++kk)
          if (kk < D) acc = fmaf(obs_s[e * DMAX + kk], w1r[kk], acc);
        h1t[tid * H1SW + e] = fmaxf(add(acc, b1r), 0.0f);
      }
      __syncthreads();
      // layer 2: envs EWW*warp.., the block's units 4*lane..; then the
      // head's sums over the block's units, into both blocks
      float acc[EWW][UL];
#pragma unroll
      for (int e = 0; e < EWW; ++e)
#pragma unroll
        for (int i = 0; i < UL; ++i) acc[e][i] = 0.0f;
#pragma unroll 4
      for (int kk = 0; kk < HW; ++kk) {
        const float4 w = *reinterpret_cast<const float4*>(w2t + kk * W2SW + 4 * lane);
        const float wv[UL] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int e4 = 0; e4 < EWW; e4 += 4) {
          const float4 h = *reinterpret_cast<const float4*>(h1t + kk * H1SW + EWW * warp + e4);
          const float hv[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int i = 0; i < UL; ++i)
              acc[e4 + e][i] = fmaf(hv[e], wv[i], acc[e4 + e][i]);
        }
      }
#pragma unroll
      for (int e = 0; e < EWW; ++e) {
#pragma unroll
        for (int q = 0; q < A; ++q) {
          float p = 0.0f;
#pragma unroll
          for (int i = 0; i < UL; ++i)
            p = fmaf(fmaxf(add(acc[e][i], b2r[i]), 0.0f), wmur[q][i], p);
          p = warp_sum(p);
          if (lane == 0) {
            const int at = (rank * EC + EWW * warp + e) * A + q;
            hd[at] = p;
            head_peer[(t & 1) * HEAD + at] = p;
          }
        }
      }
      cluster.sync();   // both halves of every env's head in both blocks
    }
    if (live) {
      float mu[A] = {0.0f, 0.0f};
      if (actor) {
#pragma unroll
        for (int q = 0; q < A; ++q)
          mu[q] = add(add(hd[tid * A + q], hd[(EC + tid) * A + q]), bmur[q]);
      }
      env_step<ENV, TASK>(a, k, tn, actor, writer, mu, sd, log_sd, act, logp,
                          u0, u1, obs_s + tid * DMAX, L);
    }
  }

  if (!writer) return;
  // the final env state and accumulators; the cluster's sums, warp 0's
  // plus warp 1's
  if (live) lane_store<ENV>(a, n, obs_s + tid * DMAX, L);
  if (stepper) {
    warp_sums(a.M, L);
    if (warp == 1 && lane == 0) {
      s_fin[0] = L.fin_r;
      s_fin[1] = L.fin_l;
      for (int m = 0; m < a.M; ++m) s_fin[2 + m] = L.fin_c[m];
      s_done = L.done_n;
    }
  }
  __syncthreads();
  if (tid == 0) {
    L.fin_r = add(L.fin_r, s_fin[0]);
    L.fin_l = add(L.fin_l, s_fin[1]);
    for (int m = 0; m < a.M; ++m) L.fin_c[m] = add(L.fin_c[m], s_fin[2 + m]);
    L.done_n += s_done;
    s_last = put_row(a, row, rows, L);
  }
  __syncthreads();
  if (!s_last || warp != 0) return;
  // the last cluster to finish: the clusters' sums, in a fixed order
  sum_rows(a, rows, lane);
}

template <int ENV, int TASK, int E>
int launch(const Args& a, const Consts& k, cudaStream_t s) {
  const cudaError_t rc = cudaFuncSetAttribute(
      rollout_kernel<ENV, TASK, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<E>());
  if (rc != cudaSuccess) return (int)rc;
  rollout_kernel<ENV, TASK, E><<<(a.N + E - 1) / E, NT, smem_bytes<E>(), s>>>(a, k);
  return (int)cudaGetLastError();
}

template <int ENV, int TASK>
int launch_h256(const Args& a, const Consts& k, cudaStream_t s) {
  const cudaError_t rc = cudaFuncSetAttribute(
      rollout_kernel_h256<ENV, TASK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes_h256());
  if (rc != cudaSuccess) return (int)rc;
  rollout_kernel_h256<ENV, TASK>
      <<<RANKS * ((a.N + EC - 1) / EC), NTW, smem_bytes_h256(), s>>>(a, k);
  return (int)cudaGetLastError();
}

template <int ENV, int TASK>
int launch_width(const Args& a, const Consts& k, int hidden, int tile, cudaStream_t s) {
  if (hidden == HW) return launch_h256<ENV, TASK>(a, k, s);
  return tile == 16 ? launch<ENV, TASK, 16>(a, k, s) : launch<ENV, TASK, 32>(a, k, s);
}

}  // namespace

// env: 0 car, 1 ball; task: 0 run, 1 circle, 2 circle with a speed limit;
// hidden: the width of both layers, 128 or 256; tile: the envs a block at
// 128 (16 or 32), a cluster at 256 (64). The wrapper's scratch holds one
// row of sums a block, or a cluster.
extern "C" int fsrl_rollout(const RolloutArgs* a, const RolloutConsts* k,
                            int env, int task, int hidden, int tile,
                            void* stream) {
  if (a->T <= 0 || a->N <= 0) return 0;
  const bool shape = hidden == HW ? tile == EC
                                  : hidden == H && (tile == 16 || tile == 32);
  if (a->D > DMAX || a->M > MMAX || !shape) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (env == CAR) {
    if (task == RUN) return launch_width<CAR, RUN>(*a, *k, hidden, tile, s);
    if (task == CIRCLE) return launch_width<CAR, CIRCLE>(*a, *k, hidden, tile, s);
    return launch_width<CAR, CIRCLE2>(*a, *k, hidden, tile, s);
  }
  if (task == RUN) return launch_width<BALL, RUN>(*a, *k, hidden, tile, s);
  if (task == CIRCLE) return launch_width<BALL, CIRCLE>(*a, *k, hidden, tile, s);
  return launch_width<BALL, CIRCLE2>(*a, *k, hidden, tile, s);
}

// The argument structs' sizes, for the wrapper to check its copies against.
extern "C" int fsrl_rollout_struct_bytes(int consts) {
  return consts ? (int)sizeof(RolloutConsts) : (int)sizeof(RolloutArgs);
}
