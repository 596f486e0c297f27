// K2 and K3: n_steps implicit-Euler substeps of an articulated body with the
// actuation torque held fixed; K3 also scales the body masses, inertias, dof
// dampings and the ground friction by per-env rand-params multipliers.
//
// Replaces the TPU kernel promp_tpu/ops/pallas_substep.py::make_pallas_chain
// (its `kernel` closure at pallas_substep.py:143, pl.pallas_call at :188),
// K3 with mod_keys (reached through make_vmappable_chain_mods at :252, the
// mods packed by _pack_mods and unpacked by _unpack_mods_rows, :90-114).
// This file is a template: ops/substep_kernel.py fills in its marked places
// from the model spec. The substep is emitted by envs/mujoco/spatial.py (its
// C back end) as single-assignment float temporaries with every model
// constant folded in as a float32 literal; in K3 the multiplied constants are
// the literal times the env's multiplier, a column of its mods row m, whose
// columns follow the sorted mod keys: body_inertia (3 nb, [b, k] at
// 3 b + k), body_mass (nb), dof_damping (nv), friction (1); nm = 38 for
// walker2d and half_cheetah, 23 for hopper, 0 for K2, which reads none.
//
// Bound at the main path's shape (B = 800 envs; walker2d K3: 3,508 float ops
// a substep, 8 substeps; half_cheetah K2: 3,729 ops, 5 substeps): the ops at
// 67 TFLOP/s FP32, 0.34 us and 0.22 us, against q, qd, tau (and the mods row)
// read once and q, qd written once at 3.35 TB/s, 0.08 us and 0.04 us.
//
// What held the first design back: one thread ran an env's whole substep,
// ~3.5k dependent-ish operations in series, from a straight-line block of
// several thousand instructions; at B = 800 that is 25 one-warp blocks, one
// warp on each busy SM, which hides neither latency nor an instruction-cache
// miss. The substep is not serial: its longest dependence chain is ~100 ops
// and its mean width ~35.
//
// This design: a block holds 32 envs x kParts warps; the lane is the env and
// the warp is the part. ops/substep_schedule.py splits the substep's
// operations into kParts parts and ~30 stages; every lane of a warp runs its
// part's code for its own env (the `switch (part)` is uniform in a warp),
// laid out as one straight-line stream a part, and a block barrier ends each
// stage. A value that another part reads goes through shared memory,
// s[slot][lane] (lane-contiguous, so no bank conflicts), in a slot reused
// only after its last reader's stage; a value only its own part reads later
// stays in a register slot r[k]. The state lives in shared memory as well, in
// two buffers of q, qd rows that swap every substep, with tau and the mods
// row beside them, so each substep's barrier also publishes the next state.
// Lanes past the batch clamp their loads to the last env, run every stage
// and reach every barrier, and store nothing.
//
// What the card showed (PERF.md §6, chip_smoke.py timed in turns against the
// one-thread kernels in one call): no clear gain. The split about doubles
// the code (the shipped 8-warp walker2d K3: 11,304 SASS instructions against
// the one-thread kernel's 5,784), since at 8 warps some 1,200 values a
// substep cross parts, each stored and loaded through shared memory; what
// the warps win in latency, the extra instructions give back. Why an SM
// issues this code no faster is not measured. One hypothesis, which waits
// for a profiler trace, is the fetch of the unrolled body, refetched every
// substep; another is shared-load latency.
//
// Rounding: each operation is computed once, from the same operands in the
// same order as in the emitted body, built without fast math (cosf/sinf/sqrtf
// and IEEE division) and with -fmad=false (no multiply-add contraction): the
// kernel rounds op for op like its plain version, the same emitted algebra
// run eagerly in PyTorch. jnp.maximum/minimum propagate NaN where fmaxf/fminf
// drop it, so max/min are nan_max/nan_min: a diverged env shows NaN in both.
#include <cuda_runtime.h>

namespace {

constexpr int kNv = /*@NV@*/;
constexpr int kNm = /*@NM@*/;
constexpr int kParts = /*@NPARTS@*/;
constexpr int kSlots = /*@SLOTS@*/;
constexpr int kRegs = /*@REGS@*/;
constexpr int kLanes = 32;
constexpr int kThreads = kLanes * kParts;
// shared rows of kLanes floats: two state buffers (q then qd), tau, the mods
// row and the value slots
constexpr int kRowX0 = 0;
constexpr int kRowX1 = 2 * kNv;
constexpr int kRowTau = 4 * kNv;
constexpr int kRowM = 5 * kNv;
constexpr int kRowS = 5 * kNv + kNm;
constexpr int kRows = kRowS + kSlots;
constexpr int kSharedBytes = kRows * kLanes * 4;

typedef float Row[kLanes];

// NaN-propagating max/min against a constant, as jnp.maximum/jnp.minimum.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// The block barrier that ends a stage. Each warp reaches it from its own
// part's code (a warp-uniform branch), so it is the named barrier 1 over
// all the block's threads, as warp-specialised kernels use it, and a memory
// clobber keeps the compiler from moving shared accesses across it.
__device__ __forceinline__ void stage_barrier() {
  asm volatile("bar.sync 1, %0;" : : "r"(kThreads) : "memory");
}

// The scheduled substep: block_K_P(lane, ...) computes part P's operations
// of stage K for the env in `lane`, reading the state q, qd, tau and m, the
// slots s and its registers r, and writing slots, registers and the next
// state q2, qd2.
/*@BLOCKS@*/

// Thread `tid` of the block whose first env is `env0` copies its share of
// the block's (batch, nv) and (batch, nm) rows into the shared rows, lane =
// env (the state's global reads contiguous across threads); lanes past the
// batch take the last env's rows.
__device__ __forceinline__ void load_rows(
    int tid, int env0, int batch, const float* __restrict__ q_in,
    const float* __restrict__ qd_in, const float* __restrict__ tau_in,
    const float* __restrict__ mods_in, Row* __restrict__ sh) {
  for (int k = tid; k < kLanes * kNv; k += kThreads) {
    const int lane = k / kNv, j = k % kNv;
    const int env = env0 + lane < batch ? env0 + lane : batch - 1;
    const size_t at = static_cast<size_t>(env) * kNv + j;
    sh[kRowX0 + j][lane] = q_in[at];
    sh[kRowX0 + kNv + j][lane] = qd_in[at];
    sh[kRowTau + j][lane] = tau_in[at];
  }
  for (int k = tid; k < kLanes * kNm; k += kThreads) {
    const int lane = k % kLanes, i = k / kLanes;
    const int env = env0 + lane < batch ? env0 + lane : batch - 1;
    sh[kRowM + i][lane] = mods_in[static_cast<size_t>(env) * kNm + i];
  }
}

// Thread `tid` writes its share of the final state `x` (q then qd rows) to
// the outputs, for the lanes inside the batch only.
__device__ __forceinline__ void store_rows(
    int tid, int env0, int batch, const Row* __restrict__ x,
    float* __restrict__ q_out, float* __restrict__ qd_out) {
  for (int k = tid; k < kLanes * kNv; k += kThreads) {
    const int lane = k / kNv, j = k % kNv;
    if (env0 + lane < batch) {
      const size_t at = static_cast<size_t>(env0 + lane) * kNv + j;
      q_out[at] = x[j][lane];
      qd_out[at] = x[kNv + j][lane];
    }
  }
}

__global__ void __launch_bounds__(kThreads) substep_chain_kernel(
    const float* __restrict__ q_in, const float* __restrict__ qd_in,
    const float* __restrict__ tau_in, const float* __restrict__ mods_in,
    float* __restrict__ q_out, float* __restrict__ qd_out, int batch,
    int n_steps) {
  extern __shared__ float4 shared_words[];
  Row* sh = reinterpret_cast<Row*>(shared_words);
  const int tid = threadIdx.x;
  const int lane = tid % kLanes, part = tid / kLanes;
  const int env0 = blockIdx.x * kLanes;
  load_rows(tid, env0, batch, q_in, qd_in, tau_in, mods_in, sh);
  __syncthreads();
  float r[kRegs > 0 ? kRegs : 1];
  Row* const s = sh + kRowS;
  const Row* const tau = sh + kRowTau;
  const Row* const m = sh + kRowM;
  // each warp runs its own part's straight-line code through every stage
  // and substep, so its instruction stream is contiguous; stage k of
  // substep `step` reads the state x and writes the next state y
  switch (part) {
/*@PARTS@*/
  }
  store_rows(tid, env0, batch, sh + (n_steps & 1 ? kRowX1 : kRowX0), q_out,
             qd_out);
}

}  // namespace

// Launches the chain on `stream` over `batch` envs (`mods` is the (batch,
// nm) multipliers, unread when nm = 0); returns the first cudaError_t of
// raising the kernel's dynamic shared memory limit (once a device) and of
// the launch (0 when both were accepted).
extern "C" int substep_chain_launch(const float* q, const float* qd,
                                    const float* tau, const float* mods,
                                    float* q_out, float* qd_out, int batch,
                                    int n_steps, void* stream) {
  if (batch <= 0) return 0;
  constexpr int kMaxDevices = 64;
  static bool raised[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices || !raised[device]) {
    err = cudaFuncSetAttribute(substep_chain_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSharedBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < kMaxDevices) raised[device] = true;
  }
  const int blocks = (batch + kLanes - 1) / kLanes;
  substep_chain_kernel<<<blocks, kThreads, kSharedBytes,
                         static_cast<cudaStream_t>(stream)>>>(
      q, qd, tau, mods, q_out, qd_out, batch, n_steps);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory a block takes, in bytes (for the build report).
extern "C" int substep_chain_shared_bytes() { return kSharedBytes; }
