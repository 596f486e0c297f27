// K2: n_steps implicit-Euler substeps of an articulated body, one env per
// thread, with the actuation torque held fixed.
//
// Replaces the TPU kernel promp_tpu/ops/pallas_substep.py::make_pallas_chain
// (its `kernel` closure, pl.pallas_call at pallas_substep.py:188). This file
// is a template: ops/substep_kernel.py fills in its two marked places, the
// model's dof count and the substep, both generated from the model spec by
// envs/mujoco/spatial.py (its C back end). The body is one
// straight-line block of `const float tN = ...;` temporaries with every model
// constant folded in and written as a float32 literal: FK, the CRBA mass
// matrix, the RNEA bias, the penalty ground contacts, limits/springs/damping,
// the sparse leaves-first Cholesky of (M + hC + h^2 K) and the qvel clip.
// It ends by assigning the new q[] and qd[].
//
// Design: one thread per env. q, qd and tau are read once from the (B, nv)
// row-major inputs (a thread reads its own contiguous row; a warp's rows are
// one contiguous 32 * nv * 4-byte span, so its loads share sectors), stay in
// registers through the whole chain (the arrays are indexed with constants
// only), and the final q, qd are written once. The n_steps loop runs in the
// kernel, not unrolled.
//
// Rounding: built without fast math (cosf/sinf/sqrtf and IEEE division, not
// __cosf) and with -fmad=false, so that no multiply and add are contracted
// into an FMA: the kernel then rounds op for op like its plain version, the
// same emitted algebra run eagerly in PyTorch, and the card check can hold
// them to tight bars. Whether contraction pays is left to a later change.
// jnp.maximum/minimum propagate NaN where fmaxf/fminf drop it, so max/min
// are written as nan_max/nan_min below: a diverged env shows NaN in both.
//
// Bound at the main path's shape (half_cheetah: nv 9, 24 contacts; B = 800
// envs, n_steps = 5): about 4.3k float ops a substep, so ~17 MFLOP at
// 67 TFLOP/s FP32 (~0.26 us), against 144 KB moved at 3.35 TB/s
// (~0.04 us); the launch itself outweighs both at this batch. What holds
// this design back is the serial chain of one thread: n_steps x ~4.3k
// dependent-ish operations on 25 warps.
#include <cuda_runtime.h>

namespace {

constexpr int kNv = /*@NV@*/;
constexpr int kThreads = 32;

// NaN-propagating max/min against a constant, as jnp.maximum/jnp.minimum.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__global__ void __launch_bounds__(kThreads) substep_chain_kernel(
    const float* __restrict__ q_in, const float* __restrict__ qd_in,
    const float* __restrict__ tau_in, float* __restrict__ q_out,
    float* __restrict__ qd_out, int batch, int n_steps) {
  const int env = blockIdx.x * blockDim.x + threadIdx.x;
  if (env >= batch) return;
  const size_t row = static_cast<size_t>(env) * kNv;
  float q[kNv], qd[kNv], tau[kNv];
#pragma unroll
  for (int j = 0; j < kNv; ++j) {
    q[j] = q_in[row + j];
    qd[j] = qd_in[row + j];
    tau[j] = tau_in[row + j];
  }
#pragma unroll 1
  for (int step = 0; step < n_steps; ++step) {
/*@BODY@*/
  }
#pragma unroll
  for (int j = 0; j < kNv; ++j) {
    q_out[row + j] = q[j];
    qd_out[row + j] = qd[j];
  }
}

}  // namespace

// Launches the chain on `stream` over `batch` envs; returns the launch's
// cudaError_t (0 when it was accepted).
extern "C" int substep_chain_launch(const float* q, const float* qd,
                                    const float* tau, float* q_out,
                                    float* qd_out, int batch, int n_steps,
                                    void* stream) {
  if (batch <= 0) return 0;
  const int blocks = (batch + kThreads - 1) / kThreads;
  substep_chain_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      q, qd, tau, q_out, qd_out, batch, n_steps);
  return static_cast<int>(cudaGetLastError());
}
