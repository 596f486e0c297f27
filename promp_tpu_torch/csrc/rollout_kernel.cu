// K1: the whole point-mass rollout of one meta-task per block.
//
// Replaces the TPU kernel promp_tpu/ops/pallas_rollout.py::_rollout_kernel
// (pl.pallas_call at pallas_rollout.py:138). Each step, for every env:
// the 2 -> h0 -> h1 -> 2 tanh MLP gives the mean; the action is
// mean + noise * exp(log_std) with the noise drawn outside the kernel; the
// NormalizedEnv affine maps +-10 to +-0.2 and clips; the point moves; the
// sparse corner reward is computed (L1 radius 0.5, nearest corner with
// 1e-7 slack); obs, action, mean and reward are written.
//
// Design: one block per task, one thread per env (up to 1024 a block).
// The task's W1, b1, W2, b2, W3, b3 and log_std sit in shared memory
// (17.5 KB at 64x64) and every thread of a warp reads the same weight at
// once (a broadcast). Each thread keeps its first hidden layer in its own
// column of shared memory and its obs in registers, and runs the T loop
// inside the kernel. Outputs are written in the (tasks, envs, T, .)
// layout.
//
// The arithmetic after the MLP mirrors pallas_rollout.py:49-70 op for op,
// with __fmul_rn/__fadd_rn so that nvcc contracts nothing into an FMA: the
// goal distance and the goal corner's squared distance then round alike,
// and the nearest-corner test keeps K1's form sqrt(min d^2) + 1e-7.
//
// Bound at the main-path shape (40 tasks x 20 envs x 100 steps, 64x64):
// 80,000 policy steps of (2*64 + 64*64 + 64*2) = 4,352 FMA, ~0.70 GFLOP of
// FP32 work, and ~2.9 MB moved (noise in; obs, actions, means, rewards
// out). At 67 TFLOP/s FP32 (no tensor cores) and 3.35 TB/s that is about
// 10 us. Neither is what holds this design back: each thread runs a
// serial chain of 100 dependent steps, and 40 blocks of 20 threads occupy
// 40 of 132 SMs with one partly filled warp each, so the time is the
// latency of that chain.
#include <cuda_runtime.h>

namespace {

constexpr float kScale = 10.0f;       // NormalizedEnv normalization_scale
constexpr float kActBound = 0.2f;     // MetaPointEnvCorner action bound
constexpr float kSparseRadius = 0.5f;

__device__ __forceinline__ float sq(float v) { return __fmul_rn(v, v); }

__device__ __forceinline__ float sq_norm(float u, float v) {
  return __fadd_rn(sq(u), sq(v));
}

__global__ void pointmass_rollout_kernel(
    const float* __restrict__ goals, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ w3,
    const float* __restrict__ b3, const float* __restrict__ log_std,
    const float* __restrict__ obs0, const float* __restrict__ noise,
    float* __restrict__ obs_out, float* __restrict__ act_out,
    float* __restrict__ rew_out, float* __restrict__ mean_out,
    int n_envs, int horizon, int h0, int h1) {
  extern __shared__ float smem[];
  float* s_w1 = smem;                 // (2, h0)
  float* s_b1 = s_w1 + 2 * h0;        // (h0)
  float* s_w2 = s_b1 + h0;            // (h0, h1)
  float* s_b2 = s_w2 + h0 * h1;       // (h1)
  float* s_w3 = s_b2 + h1;            // (h1, 2)
  float* s_act = s_w3 + 2 * h1;       // (h0, blockDim.x): one column a thread

  const int task = blockIdx.x;
  const int env = threadIdx.x;
  for (int i = threadIdx.x; i < 2 * h0; i += blockDim.x)
    s_w1[i] = w1[(size_t)task * 2 * h0 + i];
  for (int i = threadIdx.x; i < h0; i += blockDim.x)
    s_b1[i] = b1[(size_t)task * h0 + i];
  for (int i = threadIdx.x; i < h0 * h1; i += blockDim.x)
    s_w2[i] = w2[(size_t)task * h0 * h1 + i];
  for (int i = threadIdx.x; i < h1; i += blockDim.x)
    s_b2[i] = b2[(size_t)task * h1 + i];
  for (int i = threadIdx.x; i < 2 * h1; i += blockDim.x)
    s_w3[i] = w3[(size_t)task * h1 * 2 + i];
  __syncthreads();
  if (env >= n_envs) return;

  const float gx = goals[task * 2 + 0];
  const float gy = goals[task * 2 + 1];
  const float bias_m0 = b3[task * 2 + 0];
  const float bias_m1 = b3[task * 2 + 1];
  const float std0 = expf(log_std[task * 2 + 0]);
  const float std1 = expf(log_std[task * 2 + 1]);
  float* act = s_act + threadIdx.x;
  const int stride = blockDim.x;

  float ox = obs0[((size_t)task * n_envs + env) * 2 + 0];
  float oy = obs0[((size_t)task * n_envs + env) * 2 + 1];
  const size_t out_row = ((size_t)task * n_envs + env) * horizon;

  for (int t = 0; t < horizon; ++t) {
    // policy forward: dot products first, then the bias, as jnp.dot + b
    for (int j = 0; j < h0; ++j) {
      float acc = ox * s_w1[j];
      acc = fmaf(oy, s_w1[h0 + j], acc);
      act[j * stride] = tanhf(acc + s_b1[j]);
    }
    float m0 = 0.0f, m1 = 0.0f;
    for (int j = 0; j < h1; ++j) {
      float acc = 0.0f;
      for (int k = 0; k < h0; ++k) acc = fmaf(act[k * stride], s_w2[k * h1 + j], acc);
      const float h = tanhf(acc + s_b2[j]);
      m0 = fmaf(h, s_w3[2 * j + 0], m0);
      m1 = fmaf(h, s_w3[2 * j + 1], m1);
    }
    m0 += bias_m0;
    m1 += bias_m1;

    const size_t nz = (((size_t)task * horizon + t) * n_envs + env) * 2;
    const float a0 = __fadd_rn(m0, __fmul_rn(noise[nz + 0], std0));
    const float a1 = __fadd_rn(m1, __fmul_rn(noise[nz + 1], std1));

    // NormalizedEnv affine +-scale -> +-act_bound, then the env's clip
    const float c0 = fminf(fmaxf(__fadd_rn(-kActBound, __fdiv_rn(__fmul_rn(
        __fadd_rn(a0, kScale), 2.0f * kActBound), 2.0f * kScale)),
        -kActBound), kActBound);
    const float c1 = fminf(fmaxf(__fadd_rn(-kActBound, __fdiv_rn(__fmul_rn(
        __fadd_rn(a1, kScale), 2.0f * kActBound), 2.0f * kScale)),
        -kActBound), kActBound);

    const float nx = __fadd_rn(ox, c0);
    const float ny = __fadd_rn(oy, c1);
    const float goal_d = sqrtf(sq_norm(__fsub_rn(nx, gx), __fsub_rn(ny, gy)));
    const float dist_l1 = __fadd_rn(fabsf(nx), fabsf(ny));
    const float xp = __fadd_rn(nx, 2.0f), xm = __fsub_rn(nx, 2.0f);
    const float yp = __fadd_rn(ny, 2.0f), ym = __fsub_rn(ny, 2.0f);
    const float d2 = fminf(fminf(sq_norm(xp, yp), sq_norm(xm, yp)),
                           fminf(sq_norm(xp, ym), sq_norm(xm, ym)));
    const bool nearest = goal_d <= __fadd_rn(sqrtf(d2), 1e-7f);
    const float prev_d = sqrtf(sq_norm(__fsub_rn(ox, gx), __fsub_rn(oy, gy)));
    const float reward = dist_l1 < kSparseRadius
                             ? 0.0f
                             : (nearest ? __fsub_rn(prev_d, goal_d) : 0.0f);

    const size_t o = (out_row + t) * 2;
    obs_out[o + 0] = ox;
    obs_out[o + 1] = oy;
    act_out[o + 0] = a0;
    act_out[o + 1] = a1;
    mean_out[o + 0] = m0;
    mean_out[o + 1] = m1;
    rew_out[out_row + t] = reward;
    ox = nx;
    oy = ny;
  }
}

}  // namespace

// Plain-C entry point for ctypes. Launches one block of n_envs rounded up
// to a warp per task on ``stream`` and returns the cudaError_t of the
// launch (0 on success; a shared-memory request over the block's limit
// fails here); it does not synchronise.
extern "C" int pointmass_rollout_launch(
    const float* goals, const float* w1, const float* b1, const float* w2,
    const float* b2, const float* w3, const float* b3, const float* log_std,
    const float* obs0, const float* noise, float* obs_out, float* act_out,
    float* rew_out, float* mean_out, int n_tasks, int n_envs, int horizon,
    int h0, int h1, void* stream) {
  const int threads = (n_envs + 31) / 32 * 32;
  const size_t smem = sizeof(float) *
      ((size_t)2 * h0 + h0 + (size_t)h0 * h1 + h1 + 2 * h1 + (size_t)h0 * threads);
  cudaError_t err = cudaFuncSetAttribute(
      pointmass_rollout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  pointmass_rollout_kernel<<<n_tasks, threads, smem, (cudaStream_t)stream>>>(
      goals, w1, b1, w2, b2, w3, b3, log_std, obs0, noise, obs_out, act_out,
      rew_out, mean_out, n_envs, horizon, h0, h1);
  return (int)cudaGetLastError();
}
