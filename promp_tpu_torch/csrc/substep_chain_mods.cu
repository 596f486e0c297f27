// K3: n_steps implicit-Euler substeps of an articulated body with per-env
// rand-params physics multipliers, one env per thread, with the actuation
// torque held fixed.
//
// Replaces the TPU kernel promp_tpu/ops/pallas_substep.py::make_pallas_chain
// with mod_keys (its `kernel` closure at pallas_substep.py:143, pl.pallas_call
// at :188, reached through make_vmappable_chain_mods at :252; the mods packed
// by _pack_mods and unpacked by _unpack_mods_rows, :90-114). This file is a
// template: ops/substep_kernel.py fills in its three marked places, the
// model's dof count, the packed mods row's length nm and the substep, all
// generated from the model spec by envs/mujoco/spatial.py (its C back end).
// The body is K2's (csrc/substep_chain.cu) except where a multiplier enters:
// each body mass, inertia, dof damping and the ground friction is the folded
// float32 literal times the env's multiplier m[i], a runtime float, and what
// K2 folded from them is computed. The columns of m follow the sorted mod
// keys: body_inertia (3 nb, [b, k] at 3 b + k), body_mass (nb), dof_damping
// (nv), friction (1); nm = 38 for walker2d and half_cheetah, 23 for hopper.
//
// Design: one thread per env, as K2. q, qd and tau are read once from the
// (B, nv) row-major inputs and the mods once from the (B, nm) row-major
// input, before the n_steps loop: a thread reads its own contiguous rows, so
// a warp's loads are one contiguous 32 * nv * 4- (or 32 * nm * 4-) byte span
// and share sectors. Everything stays in registers through the chain (the
// arrays are indexed with constants only), and the final q, qd are written
// once. The products of the multipliers with the model's constants do not
// change across substeps; whether the compiler hoists them out of the loop
// is its choice (without fast math either way rounds alike).
//
// Rounding: as K2, no fast math and -fmad=false, so K3 rounds op for op like
// its plain version; nan_max/nan_min keep jnp's NaN propagation.
//
// Bound at the main path's shape (walker2d: nv 9, nm 38, 21 contacts;
// B = 800 envs, n_steps = 8): the emitted ops (about 3.6k a substep, the
// card check prints the count) x 8 x 800 at 67 TFLOP/s FP32 (~0.34 us),
// against q, qd, tau and the mods read and q, qd written, 800 x (5 x 9 + 38)
// x 4 B = 266 KB at 3.35 TB/s (~0.08 us). As for K2, the launch and the
// serial chain of one thread outweigh both at this batch; the design keeps
// all per-env state in registers, so nothing but the launch's own bytes
// touches memory.
#include <cuda_runtime.h>

namespace {

constexpr int kNv = /*@NV@*/;
constexpr int kNm = /*@NM@*/;
constexpr int kThreads = 32;

// NaN-propagating max/min against a constant, as jnp.maximum/jnp.minimum.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__global__ void __launch_bounds__(kThreads) substep_chain_mods_kernel(
    const float* __restrict__ q_in, const float* __restrict__ qd_in,
    const float* __restrict__ tau_in, const float* __restrict__ mods_in,
    float* __restrict__ q_out, float* __restrict__ qd_out, int batch,
    int n_steps) {
  const int env = blockIdx.x * blockDim.x + threadIdx.x;
  if (env >= batch) return;
  const size_t row = static_cast<size_t>(env) * kNv;
  const size_t mrow = static_cast<size_t>(env) * kNm;
  float q[kNv], qd[kNv], tau[kNv], m[kNm];
#pragma unroll
  for (int j = 0; j < kNv; ++j) {
    q[j] = q_in[row + j];
    qd[j] = qd_in[row + j];
    tau[j] = tau_in[row + j];
  }
#pragma unroll
  for (int i = 0; i < kNm; ++i) {
    m[i] = mods_in[mrow + i];
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
extern "C" int substep_chain_mods_launch(const float* q, const float* qd,
                                         const float* tau, const float* mods,
                                         float* q_out, float* qd_out,
                                         int batch, int n_steps,
                                         void* stream) {
  if (batch <= 0) return 0;
  const int blocks = (batch + kThreads - 1) / kThreads;
  substep_chain_mods_kernel<<<blocks, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      q, qd, tau, mods, q_out, qd_out, batch, n_steps);
  return static_cast<int>(cudaGetLastError());
}
