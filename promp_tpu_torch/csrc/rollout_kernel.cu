// K1: the whole point-mass rollout of one meta-task's envs.
//
// Replaces the TPU kernel promp_tpu/ops/pallas_rollout.py::_rollout_kernel
// (pl.pallas_call at pallas_rollout.py:138). Each step, for every env:
// the 2 -> h0 -> h1 -> 2 tanh MLP gives the mean; the action is
// mean + noise * exp(log_std) with the noise drawn outside the kernel; the
// NormalizedEnv affine maps +-10 to +-0.2 and clips; the point moves; the
// sparse corner reward is computed (L1 radius 0.5, nearest corner with
// 1e-7 slack); obs, action, mean and reward are written in the
// (tasks, envs, T, .) layout.
//
// Bound at the main-path shape (40 tasks x 20 envs x 100 steps, 64x64):
// 80,000 policy steps of (2*64 + 64*64 + 64*2) = 4,352 FMA, 0.70 GFLOP of
// FP32 work, 10.4 us at 67 TFLOP/s (no tensor cores); the 3.6 MB moved
// would take 1.1 us at 3.35 TB/s. A design reaches that bound only on the
// SMs its grid fills: the first design (one block a task, one thread an
// env running the env's whole chain) filled 40 of 132 SMs, a floor of
// 34 us, and ran at ~3.7 ms, the latency of each thread's 100 steps of
// 4,352 FMAs in series.
//
// This design: a warp steps one env, and a block holds the kE = 2 envs
// (warps) of one task's group; the grid is (task, group), 40 x 20 = 800
// warps at the main shape, 6-8 on each SM (400 blocks, at most 4 on an
// SM: a floor of 8 envs' work on the busiest SM, 14 us). Lane l owns the
// hidden units l, l + 32, ... of both layers and holds their weights in
// registers for the whole rollout: W1 and b1 entries, b2 entries and,
// where its kU1 columns of W2 hold at most 128 floats (h1 <= 64 at
// h0 = 64), those columns (else they are read from shared memory). A step:
//   1. each lane computes its layer-1 units and writes them to its warp's
//      row in shared memory; __syncwarp;
//   2. each lane runs one FMA chain over k per layer-2 unit, reading the
//      layer-1 row as float4 broadcasts, and writes its layer-2 units to
//      the warp's second row; __syncwarp;
//   3. every lane runs the output layer over that row (W3 broadcast from
//      shared memory), the action map and the env step, so every lane
//      holds the env's next position in registers and no barrier is
//      needed between steps.
// Lane s keeps step t0 + s's position, action and mean in registers;
// every 32 steps, and at the end, the lanes compute the rewards of those
// steps at once and write the chunk's outputs, consecutive lanes at
// consecutive addresses. The next step's noise is loaded a step ahead.
// Warps past n_envs (the last group's ragged edge) leave after the weights
// are staged and store nothing.
//
// Rounding: every sum runs in the first design's order, one fmaf chain in
// ascending k from 0 (layer 1: x*w then fmaf(y, w', .)), then the bias,
// then tanhf; the output layer is the same sequential chain over the units,
// then the bias. The arithmetic after the MLP mirrors pallas_rollout.py:49-70
// op for op, with __fmul_rn/__fadd_rn so that nvcc contracts nothing into an
// FMA: the goal distance and the goal corner's squared distance then round
// alike, and the nearest-corner test keeps K1's form sqrt(min d^2) + 1e-7.
// No fast math, no TF32: the kernel is bitwise the first design's.
//
// Built once per width pair: ops/rollout_kernel.py passes -DK1_H0, -DK1_H1
// and -DK1_W2_REG (its launch_geometry makes the width-based choice and
// checks this build's shared bytes against its own at load). The block
// size kE and the shared layout are this file's.
#include <cuda_runtime.h>

#if !defined(K1_H0) || !defined(K1_H1) || !defined(K1_W2_REG)
#error "build through promp_tpu_torch/ops/rollout_kernel.py (-DK1_*)"
#endif

namespace {

constexpr int kH0 = K1_H0;            // first hidden layer's width
constexpr int kH1 = K1_H1;            // second hidden layer's width
constexpr int kE = 2;                 // envs (warps) a block
constexpr bool kW2InRegisters = K1_W2_REG != 0;
constexpr int kU0 = (kH0 + 31) / 32;  // layer-1 units a lane
constexpr int kU1 = (kH1 + 31) / 32;  // layer-2 units a lane
constexpr int kThreads = 32 * kE;
constexpr int kMaxGroups = 65535;     // the grid's second dimension

constexpr int round4(int n) { return (n + 3) / 4 * 4; }
// Shared memory, in floats; every array starts on 16 bytes.
constexpr int kRow0 = round4(kH0);                  // a warp's layer-1 row
constexpr int kRow1 = round4(kH1);                  // a warp's layer-2 row
constexpr int kW3At = 0;                            // (kH1, 2)
constexpr int kHid0At = kW3At + 2 * kRow1;          // (kE, kRow0)
constexpr int kHid1At = kHid0At + kE * kRow0;       // (kE, kRow1)
constexpr int kW2At = kHid1At + kE * kRow1;         // (kH0, kH1) if shared
constexpr int kSharedBytes =
    4 * (kW2At + (kW2InRegisters ? 0 : kH0 * kH1));

constexpr float kScale = 10.0f;       // NormalizedEnv normalization_scale
constexpr float kActBound = 0.2f;     // MetaPointEnvCorner action bound
constexpr float kSparseRadius = 0.5f;

__device__ __forceinline__ float sq(float v) { return __fmul_rn(v, v); }

__device__ __forceinline__ float sq_norm(float u, float v) {
  return __fadd_rn(sq(u), sq(v));
}

// The sparse corner reward of the step (ox, oy) -> (nx, ny) for the goal
// (gx, gy).
__device__ __forceinline__ float corner_reward(float ox, float oy, float nx,
                                               float ny, float gx, float gy) {
  const float goal_d = sqrtf(sq_norm(__fsub_rn(nx, gx), __fsub_rn(ny, gy)));
  const float dist_l1 = __fadd_rn(fabsf(nx), fabsf(ny));
  const float xp = __fadd_rn(nx, 2.0f), xm = __fsub_rn(nx, 2.0f);
  const float yp = __fadd_rn(ny, 2.0f), ym = __fsub_rn(ny, 2.0f);
  const float d2 = fminf(fminf(sq_norm(xp, yp), sq_norm(xm, yp)),
                         fminf(sq_norm(xp, ym), sq_norm(xm, ym)));
  const bool nearest = goal_d <= __fadd_rn(sqrtf(d2), 1e-7f);
  const float prev_d = sqrtf(sq_norm(__fsub_rn(ox, gx), __fsub_rn(oy, gy)));
  return dist_l1 < kSparseRadius
             ? 0.0f
             : (nearest ? __fsub_rn(prev_d, goal_d) : 0.0f);
}

// NormalizedEnv's affine map of an action from +-scale to +-act_bound,
// then the env's clip.
__device__ __forceinline__ float env_action(float a) {
  return fminf(fmaxf(__fadd_rn(-kActBound, __fdiv_rn(__fmul_rn(
      __fadd_rn(a, kScale), 2.0f * kActBound), 2.0f * kScale)),
      -kActBound), kActBound);
}

__global__ void __launch_bounds__(kThreads) pointmass_rollout_kernel(
    const float* __restrict__ goals, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ w3,
    const float* __restrict__ b3, const float* __restrict__ log_std,
    const float* __restrict__ obs0, const float* __restrict__ noise,
    float* __restrict__ obs_out, float* __restrict__ act_out,
    float* __restrict__ rew_out, float* __restrict__ mean_out,
    int n_envs, int horizon) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* s_w3 = smem + kW3At;
  float* s_w2 = smem + kW2At;

  const int task = blockIdx.x;
  for (int i = threadIdx.x; i < 2 * kH1; i += kThreads)
    s_w3[i] = w3[(size_t)task * 2 * kH1 + i];
  if constexpr (!kW2InRegisters) {
    for (int i = threadIdx.x; i < kH0 * kH1; i += kThreads)
      s_w2[i] = w2[(size_t)task * kH0 * kH1 + i];
  }
  __syncthreads();   // the block's only barrier

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int env = blockIdx.y * kE + warp;
  if (env >= n_envs) return;
  float* s_h0 = smem + kHid0At + warp * kRow0;
  float* s_h1 = smem + kHid1At + warp * kRow1;

  // the lane's units' weights, held for the whole rollout (0 past a width)
  float w1x[kU0], w1y[kU0], b1u[kU0], b2u[kU1];
  float w2c[kW2InRegisters ? kU1 : 1][kW2InRegisters ? kH0 : 1];
#pragma unroll
  for (int u = 0; u < kU0; ++u) {
    const int j = u * 32 + lane;
    const bool in = j < kH0;
    w1x[u] = in ? w1[(size_t)task * 2 * kH0 + j] : 0.0f;
    w1y[u] = in ? w1[(size_t)task * 2 * kH0 + kH0 + j] : 0.0f;
    b1u[u] = in ? b1[(size_t)task * kH0 + j] : 0.0f;
  }
#pragma unroll
  for (int u = 0; u < kU1; ++u) {
    const int j = u * 32 + lane;
    const bool in = j < kH1;
    b2u[u] = in ? b2[(size_t)task * kH1 + j] : 0.0f;
    if constexpr (kW2InRegisters) {
#pragma unroll
      for (int k = 0; k < kH0; ++k)
        w2c[u][k] = in ? w2[((size_t)task * kH0 + k) * kH1 + j] : 0.0f;
    }
  }

  const size_t row = (size_t)task * n_envs + env;   // (tasks, envs)
  // noise is (tasks, T, envs, 2): step t of this env at noise_at + t * step
  const size_t noise_at = ((size_t)task * horizon * n_envs + env) * 2;
  const size_t noise_step = (size_t)n_envs * 2;
  const float gx = goals[task * 2 + 0];
  const float gy = goals[task * 2 + 1];
  const float bias_m0 = b3[task * 2 + 0];
  const float bias_m1 = b3[task * 2 + 1];
  const float std0 = expf(log_std[task * 2 + 0]);
  const float std1 = expf(log_std[task * 2 + 1]);
  float ox = obs0[row * 2 + 0];
  float oy = obs0[row * 2 + 1];
  float n0 = noise[noise_at + 0];
  float n1 = noise[noise_at + 1];
  // step t0 + lane of the current chunk of 32: the position before and
  // after it, its action and its mean
  float kx = 0.0f, ky = 0.0f, kx1 = 0.0f, ky1 = 0.0f;
  float ka0 = 0.0f, ka1 = 0.0f, km0 = 0.0f, km1 = 0.0f;

  for (int t = 0; t < horizon; ++t) {
    float next0 = 0.0f, next1 = 0.0f;
    if (t + 1 < horizon) {
      next0 = noise[noise_at + (t + 1) * noise_step + 0];
      next1 = noise[noise_at + (t + 1) * noise_step + 1];
    }

    // 1. layer 1: the dot product first, then the bias, as jnp.dot + b
#pragma unroll
    for (int u = 0; u < kU0; ++u) {
      if (u * 32 + lane < kH0) {
        float acc = ox * w1x[u];
        acc = fmaf(oy, w1y[u], acc);
        s_h0[u * 32 + lane] = tanhf(acc + b1u[u]);
      }
    }
    __syncwarp();

    // 2. layer 2: one chain over k in ascending order a unit
    float acc[kU1];
#pragma unroll
    for (int u = 0; u < kU1; ++u) acc[u] = 0.0f;
#pragma unroll
    for (int k = 0; k < kH0; k += 4) {
      const float4 a = *reinterpret_cast<const float4*>(s_h0 + k);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (k + i < kH0) {
#pragma unroll
          for (int u = 0; u < kU1; ++u) {
            float w;
            if constexpr (kW2InRegisters) {
              w = w2c[u][k + i];
            } else {
              w = u * 32 + lane < kH1 ? s_w2[(k + i) * kH1 + u * 32 + lane]
                                      : 0.0f;
            }
            acc[u] = fmaf(av[i], w, acc[u]);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kU1; ++u) {
      if (u * 32 + lane < kH1) s_h1[u * 32 + lane] = tanhf(acc[u] + b2u[u]);
    }
    __syncwarp();

    // 3. the output layer, the action and the env step, in every lane
    float m0 = 0.0f, m1 = 0.0f;
#pragma unroll
    for (int j = 0; j < kH1; j += 4) {
      const float4 hv = *reinterpret_cast<const float4*>(s_h1 + j);
      const float4 wa = *reinterpret_cast<const float4*>(s_w3 + 2 * j);
      const float4 wb = *reinterpret_cast<const float4*>(s_w3 + 2 * j + 4);
      const float hs[4] = {hv.x, hv.y, hv.z, hv.w};
      const float ws[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (j + i < kH1) {
          m0 = fmaf(hs[i], ws[2 * i + 0], m0);
          m1 = fmaf(hs[i], ws[2 * i + 1], m1);
        }
      }
    }
    m0 += bias_m0;
    m1 += bias_m1;
    const float a0 = __fadd_rn(m0, __fmul_rn(n0, std0));
    const float a1 = __fadd_rn(m1, __fmul_rn(n1, std1));
    const float nx = __fadd_rn(ox, env_action(a0));
    const float ny = __fadd_rn(oy, env_action(a1));

    const int s = t & 31;
    if (lane == s) {
      kx = ox, ky = oy, kx1 = nx, ky1 = ny;
      ka0 = a0, ka1 = a1, km0 = m0, km1 = m1;
    }
    if ((s == 31 || t + 1 == horizon) && lane <= s) {
      const size_t o = row * horizon + (t - s) + lane;
      reinterpret_cast<float2*>(obs_out)[o] = make_float2(kx, ky);
      reinterpret_cast<float2*>(act_out)[o] = make_float2(ka0, ka1);
      reinterpret_cast<float2*>(mean_out)[o] = make_float2(km0, km1);
      rew_out[o] = corner_reward(kx, ky, kx1, ky1, gx, gy);
    }
    ox = nx;
    oy = ny;
    n0 = next0;
    n1 = next1;
  }
}

}  // namespace

// The dynamic shared memory a block takes, in bytes.
extern "C" int pointmass_rollout_shared_bytes() { return kSharedBytes; }

// Launches the (n_tasks, ceil(n_envs / kE)) grid of kThreads threads on
// ``stream`` (cudaErrorInvalidValue, nothing launched, past kMaxGroups env
// groups). Returns the first cudaError_t of raising the block's dynamic
// shared memory limit (once a device) and of the launch; it does not
// synchronise.
extern "C" int pointmass_rollout_launch(
    const float* goals, const float* w1, const float* b1, const float* w2,
    const float* b2, const float* w3, const float* b3, const float* log_std,
    const float* obs0, const float* noise, float* obs_out, float* act_out,
    float* rew_out, float* mean_out, int n_tasks, int n_envs, int horizon,
    void* stream) {
  if (n_tasks <= 0 || n_envs <= 0 || horizon <= 0) return 0;
  const int groups = (n_envs + kE - 1) / kE;
  if (groups > kMaxGroups) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kMaxDevices = 64;
  static bool raised[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices || !raised[device]) {
    err = cudaFuncSetAttribute(pointmass_rollout_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSharedBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < kMaxDevices) raised[device] = true;
  }
  pointmass_rollout_kernel<<<dim3(n_tasks, groups), kThreads, kSharedBytes,
                             static_cast<cudaStream_t>(stream)>>>(
      goals, w1, b1, w2, b2, w3, b3, log_std, obs0, noise, obs_out, act_out,
      rew_out, mean_out, n_envs, horizon);
  return static_cast<int>(cudaGetLastError());
}
